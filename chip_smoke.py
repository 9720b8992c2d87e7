"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing its result line). Every engine runs with its default ``jit=True``
(each step segment replayed from a CUDA graph captured once per static
key, ``core/capture.py``) and ``run_torr`` likewise; phase 10 runs every
captured run of phases 3-5 and 8 again eagerly and holds the two bit for
bit:

  1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
     the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once), and the tensor-core probe of
     ``perf/mma_probe.py`` (``[probe]`` lines: the int8 and 1-bit product
     routes the hamming kernels can take, their rates on this card);
  2. every kernel against its plain PyTorch version on the card, at the
     serving paths' shapes and at reduced, ragged and tied ones (bit-equal;
     the two encodes under their agreement rule with no decided code
     differing, at 8, N_max and S x N_max rows and at a ragged shape whose
     all-zero and NaN rows must equal the plain version exactly), timed
     with CUDA events (median of 20 after warm-up) beside the plain
     version, a PyTorch library call where one exists, and the least time
     the card could take (``bound_ms``); the encodes, and their library
     call torch.matmul(z, R.T), also as device time per call from a CUDA
     graph of 20 calls (their ``ms``), with a 3xTF32 and an FP32 bound at
     each of the three row counts; ``fused_scores`` and ``delta_update`` at
     the shapes their launches use (N = N_max and S x N_max rows; L = 1
     and S rows with the whole budget and one entry weighted) the same two
     ways, ``fused_scores`` beside its int8 tensor-core bound (its
     ``bound_ms``: the card's peak rate for this work), the popcount bound
     and torch._int_mm on the unpacked +-1 codes (a reference, not the
     library column: it reads 8x the bytes); ``bank_prefix_hamming`` and
     ``packed_hamming_batched`` the same way at their launch shapes (the
     step's S x N_max rows and the ladder's reduced plans; each decide
     table on its own), their ``bound_ms`` at the card's 1-bit
     tensor-core rate (their products' route; the int8 and popcount
     bounds beside it) and PyTorch's fill of the output beside them,
     bit-equal there and on adversarial inputs (all
     ones against all zeros, equal rows, words zeroed on both sides,
     ragged N, M and W); the compact bucket tiers after phase 5;
  3. serving at the edge config (``torr_edge()``) on the multi-stream
     step's default (prefix) lowering: 16 streams in 16 slots, 4 windows
     each of the traffic ``launch/serve.py`` serves (``simulate_sequence``
     with up to N_max proposals), features -> ``ops.encode_packed`` on the
     card -> ``StreamEngine.submit`` -> ``step`` -> ``sync``; the outputs,
     telemetry and final caches must be bit-equal to the same engine on the
     CPU (the plain versions), which runs in a process of its own beside
     phases 5-8 (host-bound Python, about 100 s a traffic) and is checked
     before phase 9;
  4. a reuse check on the same streams cut to K proposals per window (K is
     the cache depth): bypass and delta must occur after each stream's
     first window, and the card must again equal the CPU engine;
  5. the serial switch engine (``StreamEngine(serial=True)``: the
     ``fused_scores`` and ``delta_update`` kernels) on both traffics;
     after the served run, the weighted entries per row of its proposals'
     ``delta_update`` launches, read from the run's telemetry, are printed
     and ``delta_update`` is checked and timed at their median (the
     report's main shape),
     and the compact (batched and scan decide) and auto engines
     (``fused="compact"``/``"auto"``: the ``packed_hamming_batched``
     decide tables and the bucket scan) on both
     traffics, each bit-equal to the card's prefix engine of phase 3 or 4
     in every field but the lowering's own telemetry encodings; on the
     reuse traffic auto must reach the compact lowering; every bucket
     tier those runs' telemetry shows is then checked and timed on
     ``bank_prefix_hamming``;
  6. ``evaluate_task`` for the five TOOD tasks at the edge config on the
     card (AP@0.5 of TorR, dense and naive HDC, and TorR's path mix), one
     task's per-frame scores and telemetry equal to the same run on the CPU
     fed the card's packed queries, which are held to the CPU's encode by
     the agreement rule;
  7. the int8 encode entry point ``ops.sign_project`` (the
     ``sign_project`` kernel) on one step's proposal features and at its
     benchmark caller's shape, held to the plain version by the agreement
     rule;
  8. the plan ladder: every level of ``build_ladder(torr_edge())`` latched
     with ``StreamEngine.set_plan`` on the prefix and compact engines (16
     streams, 2 windows each of both traffics, every step timed), and on
     the switch lowering of ``torr_window_step(plan=)`` for one stream;
     every lowering bit-equal to the card's prefix engine under the same
     plan, the telemetry's planes and bank cap checked, and the card's
     prefix engine equal to the CPU engine at two levels over the reuse
     windows;
  9. a governed run: ``AsyncStreamEngine`` on the compact lowering at
     RT-60 with a ``DeadlineTracker`` and a ``Governor`` (its warm-up
     captures every ladder level), 16 streams of the reuse windows fed
     live, window t of every stream submitted at frame time t; it prints
     p99, miss rate, shed, escalated, the ``plan_log`` and the graphs
     captured inside the served loop with their seconds, and fails unless
     a reduced plan was latched for a served step; then the run replayed
     on a fresh sync prefix engine, each step's windows, queue depths and
     plan as the async run served them, every served window and the final
     caches bit-equal;
 9a. async == sync: ``AsyncStreamEngine(paused=True, tracker=None)`` on
     the prefix and compact lowerings over both traffics' packed words of
     phases 3 and 4, and on the serial switch engine over one window a
     stream: every output, telemetry field and final cache bit-equal to
     that lowering's captured sync run of phases 3-5 (serial switch: to a
     captured sync engine's drain of the same windows); the sync drain's
     and the async engine's ms/step and windows/s, then each run again
     under torch.profiler: device busy ms and idle share against that
     run's own wall time;
 9b. the launcher once: ``run_torr_streams(16, 4, rt="RT-60",
     governor=True)`` with its metrics JSON, flight JSONL and Chrome trace
     in a temporary directory; every window served or shed and at least
     one served, the three artifacts parsed, the launches after the
     engine's warm-up at least one ``bank_prefix_hamming`` a served step;
 10. eager == captured: every run of phases 3-5 and 8 again with
     ``StreamEngine(jit=False)`` (the switch stream without a graph
     family), on the same packed words: every output, telemetry field and
     final cache bit-equal to the captured run's; each run's eager and
     captured ms/step (steps timed to their sync), then one line with each
     lowering's, the graph counts and ``torch.cuda.memory_reserved()``
     (the graph count and memory are also printed after phase 8);
 11. the device-idle share of every level and lowering of phase 8 on the
     served traffic (its second window again, under ``torch.profiler``),
     last, because a profiled step slows the steps after it.
 12. supervised recovery (run after 9b, before 10) over the reuse
     windows of phase 4 on the card's packed words, every engine warmed
     up by its factory and the launches counted from 0 after each
     warm-up (a ``bank_prefix_hamming``, and on compact two
     ``packed_hamming_batched``, every served step of the last engine):
     (a) a fault-free ``ServeSupervisor`` over ``AsyncStreamEngine(
     fused="compact")`` with an ``InMemoryStateStore`` at
     ``snapshot_every=1``, bit-equal to the captured sync compact run
     (which phase 9a's async run equals), its ms/step beside phase 9a's;
     (b) the same with a ``FaultPlan`` on the dispatcher at step 3 and on
     the collector at step 5: one restart, windows replayed, bit-equal;
     (c) a ``JsonlStateStore`` at ``snapshot_every=4`` with a collector
     fault at step 6 (windows 4 and 5 re-run silently), bit-equal; (d)
     the sync prefix ``StreamEngine`` under the supervisor with a
     dispatcher fault, bit-equal to phase 4's prefix run; (e) a crash
     loop: three engines die at step 0, ``breaker_restarts=3`` latches
     the degrade plan on the fourth, every window resolves once, and
     ``memory_allocated`` / ``memory_reserved`` are printed before the
     first engine, after each restart and after the run (the dead
     engines' graph families must be freed); (f) the launcher as a
     subprocess (``--supervise --state-store --outputs-jsonl``, 2
     streams x 10 frames) SIGKILLed once its store holds a snapshot and
     run again: the merged ledger equals a fault-free run's. Each
     recovery prints the seconds from the death to the first window the
     rebuilt engine resolved, its captures and the windows replayed and
     re-run;
 13. the gateway (run after 12, before 10): an in-process ``Gateway``
     on 127.0.0.1:0 over a supervised ``AsyncStreamEngine`` (prefix); a
     client thread opens 16 sessions and posts the reuse windows one at
     a time in seq order (uint32 words on the wire); every response's
     ``best`` and ``scores_sha256`` equal a sync prefix engine's on the
     card fed the same windows in that order; then with a dispatcher
     fault at step 3 and the client retrying after each Retry-After, the
     same responses; then ``drain()`` with a window held in flight:
     ``/readyz`` 503 not ready and a new window 503 ``draining``; request
     latency p50/p99 and the retries printed.
 14. the front end (run after 13, before 10): (a) ``aggregate_window``
     and ``eq1_frame`` on numpy-seeded event batches with padding and
     out-of-range entries at T_bins 4 x 16 x 16 and 4 x 15 x 17, bit-equal
     to the CPU; (b) ``encode_batch`` over 128 proposals (torr_edge's
     N_max) of 4 x 32 x 32 windows aggregated on the card, at
     ``EncoderConfig()``, with cuDNN's global TF32 flag set to True around
     the calls: z_e held to the CPU per proposal (rtol and atol 1e-5; a
     proposal whose CPU membrane potential came within 1e-4 of the
     threshold may miss it, at most 1 %), the bridge loss's gradients per
     tensor (||card - cpu|| <= 1e-4 ||cpu||, over the proposals not
     excused), ``query_hv`` with torr_edge's R (D = 8192) by the agreement
     rule, its ``sign_project`` launches counted; ms per ``encode_batch``;
     (c) ``examples.train_bridge.main([])`` converging by the reference's
     assertion, s/step; (d) 32 decode steps of ``rerank_step`` at
     qwen3-14b's widths (d_model 5120, vocab 151936) under the launcher's
     reranker config (D 2048, B 8, M 256, batch 4), hidden states drifting
     slowly and jumping twice: each step's q held to the CPU's encode by
     the agreement rule, the CPU fed the card's q bit-equal in rho,
     bypassed and state and within rtol 1e-5 in the logits, both paths
     taken, ``sign_project_pack`` and ``packed_hamming_batched`` launched
     once a step; ms per step, the bypass rate and both kernels timed at
     the step's shapes.
 15. LM serving (run after 14, before 10; TF32 and PyTorch's bf16/fp16
     reduced-precision GEMM reductions off, then restored): (a)
     ``launch.serve.run_lm`` at qwen3-14b's full config (40 layers,
     d_model 5120, GQA 40/8, vocab 151936, bf16 weights drawn on the
     card), batch 4, a 128-token prompt, 32 tokens with the reranker, the
     decode step replayed from a CUDA graph; the same tokens replayed
     eagerly, every step's logits and hidden state and the final cache
     bit-equal to the captured run's; ``sign_project_pack`` and
     ``packed_hamming_batched`` launched once a reranked step (31); prefill
     ms, decode ms/token (captured, and the step alone captured and eager),
     tok/s, bypass rate, peak ``memory_allocated``, the cache's copy in and
     out; (b) full widths at reduced depth in float32 (qwen3-14b and
     musicgen-large at 2 layers, llama-3.2-vision-90b at 5: one group with
     its cross layer, deepseek-v2-236b at 2: its dense layer and one MoE
     layer, capacity factor 8 so no choice drops): decode after prefill
     equals prefill of the longer prompt within 2e-2 (MLA: 2e-2 of the
     logits' scale); (c) the four families' smoke configs in float32, the
     card's prefill and 4 decode steps against the port's CPU run, with
     the score products in float32 within 1e-3 and as the model computes
     them (bfloat16) within 1e-3 widened to 2^-8 of each tensor's scale,
     and the same steps replayed from a CUDA graph bit-equal to eager; (d) ``python -m repro_torch.launch.serve --arch musicgen-large
     --batch 2 --prompt-len 16 --gen 8`` in a subprocess at the full
     config prints ``generated shape (2, 8, 4)``. In (b) and (c) every
     vector leaf (norm offsets, the VLM gate: zero at init) is drawn. The
     weights are freed before phase 10.
 16. the recurrent families and the int8 cache (run after 15, before 10,
     under phase 15's GEMM flags): (e) ``int8_dot`` (``rows`` and
     ``cols``) against its plain version (float64 products) bit for bit
     at the shapes (d) launches, at ragged ones (K = 13 in rows of 17,
     S = 1 and 4099) and with every code +-127 at S = 32768, timed at
     (d)'s shapes beside its bytes bound; (d) int8 decode from
     ``init_cache`` of qwen3-14b at its full config and of
     deepseek-v2-236b at its published widths cut to 2 layers (bf16
     weights, batch 4, 16 tokens): every step's softmax within 0.05 of the
     bf16 cache's decode (``tests/test_beyond_paper.py``'s criterion), the
     logits' largest difference, ``int8_dot`` launched twice a layer and
     step (its launches counted from 0 around this run: the kernel's main
     path), the steps replayed from a CUDA graph bit-equal to eager; (a)
     ``run_lm`` at recurrentgemma-2b's and xlstm-1.3b's full configs
     (bf16, random weights, batch 4, a 128-token prompt, 32 tokens,
     reranked), the same tokens eagerly bit-equal to the captured run,
     prefill first and warm, the captured step alone and eager against
     the bytes bound (weights once, the decode state read and written),
     the graph's copy in and clone out of the state as a row of its own,
     then the launcher's run; ``sign_project_pack`` and
     ``packed_hamming_batched`` once a reranked step; (b) both at their
     published widths cut to one group (3 and 8 layers) in float32:
     decode after prefill equals prefill of the longer prompt within
     2e-2; (c) their smoke configs, card against the port's CPU run as in
     15 (c) with a 32-token prompt, longer than the hybrid's window of
     16; (f) ``python -m repro_torch.launch.serve --arch xlstm-1.3b
     --batch 2 --prompt-len 16 --gen 8`` prints ``generated shape (2,
     8)``.
 17. LM training (run after 16, before 10, under phase 15's GEMM flags;
     its tensors freed before phase 10): (a) ``runtime.steps.
     make_train_step`` at deepseek-7b's published widths (d_model 4096,
     32 heads, d_ff 11008, vocab 102400), 4 of its 30 layers (AdamW's
     state for 30 does not fit in 80 GB), bf16, remat "nothing", 20 steps
     of 4 x 2048 ``TokenStream`` tokens: ms/step (CUDA events, median and
     spread of the steps after the first), tokens/s, MFU (6 N tokens for
     the parameters in products plus the attention as the port computes
     it, against 989 TFLOP/s bf16 dense), peak ``memory_allocated``, the
     host ms of ``batch_at``, the loss of the first and last 5 steps,
     which must fall; (b) the same widths cut to one layer in float32,
     1 x 128 tokens: the card's loss, grad norm and every gradient leaf
     against the port's CPU run; (c) the seven smoke configs (gemma-7b,
     deepseek-7b, musicgen-large, llama-3.2-vision-90b, deepseek-v3-671b
     with MTP, recurrentgemma-2b, xlstm-1.3b), the card's loss, metrics
     and gradients against the CPU's: float32 with float32 and with
     bfloat16 score products, and bfloat16; (d) ``TrainSupervisor`` at
     gemma-7b's smoke config under ``torch.use_deterministic_algorithms``
     with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: a fault at step 23 ends
     in the clean run's parameters and moments bit for bit (an op with
     no deterministic CUDA version would be named and the tolerance
     stated), then ``python -m repro_torch.launch.train --arch gemma-7b
     --smoke --steps 40`` in a subprocess prints "loss improved". The
     rules are the constants above ``phase_train``. Training launches
     none of the hand-written kernels (``phase17_launches``, all 0).
 18. the mesh layer (run after 17, before 19; ``phase_mesh``): (a)-(e)
     on a one-rank NCCL group and the dry-run; (f) one decode step of
     musicgen-large's and llama-3.2-vision-90b's smoke configs (float32,
     float32 scores) on a 2x2 ("data", "model") gloo mesh of 4 spawned CPU
     ranks under this host's torch, against the plain step: logits and
     every cache tensor within 1e-4 of its largest magnitude, within 45 s;
     (g) the int8 decode of qwen3-14b's widths cut to 4 layers (bf16,
     batch 4, 16 tokens from ``init_cache``) on the 1x1 NCCL mesh: every
     step's logits and the final cache bit-equal to the plain int8
     decode, ``int8_dot`` launched twice a layer and step.
 19. the stream-sharded async engine (run after 18, before 10;
     ``phase_stream_mesh``): ``AsyncStreamEngine(mesh=)`` at the edge
     config, 15 streams padded to 16 slots over every visible card (one
     card: two shards on cuda:0, each with its own stream and graph
     family), on the prefix and compact lowerings over both traffics'
     packed words: outputs, telemetry and final caches bit-equal to the
     unsharded async engine in as many slots, ms/step of both, each
     shard's ``bank_prefix_hamming`` and ``packed_hamming_batched``
     launches (``phase19_shard<k>_launches``); the launcher refuses
     ``--mesh`` above the card count and serves ``--mesh -1``; within
     60 s.
 20. the mesh on cards (run after 19, before 10; ``phase_mesh_cards``):
     one NCCL rank a card in spawned processes, n = 4 with four cards or
     more, 2 with two or three; every plain reference is the same work on
     rank 0's card while the other ranks wait at a barrier: (a) phase
     17's cell on 2x2 and 1x4 (1x2 and 2x1): 4 steps against the plain
     ones, losses rtol 1e-3 and mu within 0.1 of each leaf's largest,
     then 4 more; ms/step (median after the first), tokens/s, peak
     memory a card and the NCCL kernels' device time in the last step,
     profiled on rank 0;
     (b) the six families' smoke configs in float32 on 2x2 (1x2): train,
     prefill, decode and (dense, MoE) an int8 decode, by
     ``tests/test_torch_mesh_run.py``'s rules; (c) the int8 decode at
     qwen3-14b's full config on 1x4 (1x2), softmax within 0.05 of the
     bf16 cache's decode and logits within 2e-2 of one card's (or 1.5x
     the bf16 cache's own mesh-to-card distance where that is larger),
     ``int8_dot`` 1,280 launches a rank (``phase20_launches``); (d)
     ``moe_ffn_ep`` over n ranks in float32 against ``moe_ffn``; (e)
     ``compressed_psum`` and the reference's multipod loop; (f) the
     pipeline over n stages; (g) the elastic restore onto half the ranks;
     (h) ``torch.distributed.run`` of the trainer, clean and faulted,
     "loss improved". Within 300 s of the ranks' start. With one card it
     prints that it needs two and returns ``"run": false``.
     ``--phases mesh-cards`` runs 1, 18 (g) and 20 alone.

Each path's kernel launches are counted from zero around that path's run
and must all be above zero; a replayed graph adds the launches its
capture recorded (``GraphFamily``), so the counts keep their meaning.
Each phase's seconds are logged as ``[phase]`` lines. The plan-ladder
rows (captured and eager ms/step, windows/s, idle share), the async vs
sync rows, the supervised, gateway, front-end, LM and recurrent/int8 rows
and the per-kernel report (with each kernel's ``front_end_launches`` from
phase 14, ``lm_launches`` from phase 15, ``phase16_launches`` from
phase 16 and ``phase17_launches`` from phase 17; ``int8_dot``'s
``launches`` are phase 16 (d)'s) and the training rows are printed as
JSON before the last line, which is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores (an FMA is 2 operations) and TF32 FLOP/s on them
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12        # dense, on the tensor cores
PEAK_INT8_S = 1979e12       # dense int8 TOP/s, on the tensor cores
PEAK_BF16_S = 989e12        # dense bf16 FLOP/s, on the tensor cores
# 1-bit products on the tensor cores (b1 .and.popc), counted as int8 ops
# are, 64 a 32-bit word pair: the data sheet gives no rate; 8x the int8
# peak, which wgmma b1 reaches on an H100 (perf/mma_probe.py: 248.2 T word
# pairs/s against the int8 peak's 30.9 T)
PEAK_B1_S = 8 * PEAK_INT8_S
# Integer issue rates of compute capability 9.0, per SM per clock (CUDA C++
# Programming Guide, throughput table of the arithmetic instructions): 64
# 32-bit integer adds, multiply-adds or bitwise ops, 16 population counts
INT32_PER_CLK, POPC_PER_CLK = 64, 16
REPS = 20
# the classes of one block of fused_scores.cu (the tie cases put a copy of
# the maximum in each)
FS_CLASS_TILE = 128
STREAMS, WINDOWS = 16, 4
# The auto engine's EWMA folds each step one dispatch late, from a cold
# 1.0: even with no full-path proposal after the first window it first
# picks a compact tier at the seventh window, so the reuse traffic runs
# longer than the served one
REUSE_WINDOWS = 10
CPU_WINDOWS = 4             # windows the CPU reference engines replay
CPU_ENGINE_LIMIT_S = 600.0  # the serving phase's CPU engines, from their start
SERIAL_WINDOWS = 2          # the serial engine serves the first windows
EVAL_FRAMES = 4             # frames per task of the evaluate_task phase
PLAN_WINDOWS = 2            # windows per stream of each plan-ladder run
# ladder levels, as (banks, planes), at which the card's prefix engine is
# held to the CPU engine; (1, 1) carries the tau offsets
PLAN_CPU_LEVELS = ((8, 2), (1, 1))
GOVERNED_RT = "RT-60"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_times(fn, reps=REPS, warmup=3) -> list[float]:
    """CUDA-event times of ``reps`` calls of ``fn`` in ms, each call from an
    idle stream (the host's launch time is counted)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def spread(times) -> dict:
    """Median, least and most of a list of times, and their number."""
    return dict(median=statistics.median(times), min=min(times),
                max=max(times), n=len(times))


def fmt_spread(sp: dict, unit="ms") -> str:
    return (f"median {sp['median']:.4f} {unit} (min {sp['min']:.4f}, max "
            f"{sp['max']:.4f}, {sp['n']} runs)")


def device_ms(fn, calls=20, reps=10) -> float:
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured
    back to back in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events (median), so the host's time between the calls
    (wrapper, launch) is not counted. Inputs stay in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(bytes_moved: float, t_ops: float):
    """``(bound_ms, bound_by)`` from the bytes moved and the least seconds
    the operations take at their peak rate."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bits_equal(a, b) -> bool:
    """Tensors (on any device) or host arrays, equal bit for bit."""
    a, b = (torch.as_tensor(x).detach().cpu() for x in (a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == b.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def phase_card():
    from repro_torch.device import smi

    log(smi("name,power.limit"))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.perf import mma_probe

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(build.SIGNATURES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    mma_probe.probe(log)


class Rates:
    """The card's integer issue rates: SMs at the highest SM clock."""

    def __init__(self):
        from repro_torch.device import smi

        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clk = float(smi("clocks.max.sm").split()[0]) * 1e6  # "1980 MHz"
        log(f"[bound] {self.sms} SMs at {self.clk / 1e6:.0f} MHz")

    def popc_s(self, pairs: float) -> float:
        """Least seconds for ``pairs`` word pairs, each a xor, a popcount
        and an add: the slower of the popcount and the integer pipe."""
        return max(pairs / (self.sms * POPC_PER_CLK * self.clk),
                   2 * pairs / (self.sms * INT32_PER_CLK * self.clk))

    def int32_s(self, ops: float) -> float:
        return ops / (self.sms * INT32_PER_CLK * self.clk)


def _check(name, label, got, want):
    """Bit-equality of kernel outputs (a tensor or a tuple) with the plain
    version's; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    log(f"[kernel] {name} {label}: max_abs_err {err}")
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} {label} != plain")
    return err


def phase_kernels(cfg, im_cuda, rates):
    """Every kernel vs its plain version on the card, then timed."""
    from repro_torch.core import aligner

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    report = {}

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    N = STREAMS * cfg.N_max
    im_w = im_cuda.packed

    def plan_cols(qq, cap, planes):
        return tuple(x.contiguous() for x in aligner._plan_columns_bank_major(
            qq, im_cuda, cap, planes, cfg))

    report["bank_prefix_hamming"] = _prefix_kernel(cfg, im_w, words,
                                                   plan_cols, rates)
    report["fused_scores"] = _fused_scores_kernel(cfg, im_w, words,
                                                  plan_cols, rates)
    report["delta_update"] = _delta_update_kernel(cfg, im_cuda.dmajor, gen,
                                                  rates)
    report["packed_hamming_batched"] = _batched_kernel(cfg, words, dev,
                                                       rates)
    report.update(_encode_kernels(cfg, gen, dev, N))
    return report


def _adversarial(words, n, m, w):
    """Packed inputs on which a wrong decomposition shows: all ones
    against all zeros (hamming 32 w at the last boundary), equal rows
    (0), and random rows with every third word zeroed on both sides (a
    plan's disabled words), each [n, w] x [m, w]."""
    q, h = words(n, w), words(m, w)
    ones = torch.full_like(q, -1)
    zmask = (torch.arange(w, device=q.device) % 3 == 1)
    return {
        "all ones x all zeros": (ones, torch.zeros_like(h)),
        "equal rows": (q, q[:m].clone() if m <= n else
                       q.repeat(-(-m // n), 1)[:m].contiguous()),
        "masked words zeroed on both sides": (torch.where(zmask, 0, q),
                                              torch.where(zmask, 0, h)),
    }


def _hamming_time(name, label, fn, plain, moved, pairs, rates, int_mm):
    """One launch shape of a hamming kernel timed two ways (a CUDA graph of
    20 calls; one call with its host time) beside the plain version, its
    bound at the card's 1-bit tensor-core rate, the kernels' route
    (``bound_ms``: 64 operations a word pair at ``PEAK_B1_S``, against the
    bytes), the int8 tensor-core bound (``bound_int8_ms``: the same count
    at 1,979 TOP/s), the popcount bound (``bound_popc_ms``), PyTorch's
    fill of the output (``fill_ms``: writing it alone, device time) and
    ``int_mm``, torch._int_mm on the unpacked +-1 codes over the full
    width (a reference: 8x the bytes, not the same function; None below
    its 17-row minimum)."""
    b = bound(moved, 64 * pairs / PEAK_B1_S)
    b8 = bound(moved, 64 * pairs / PEAK_INT8_S)
    bp = bound(moved, rates.popc_s(pairs))
    out = fn()
    t = dict(ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
             bound_ms=b[0], bound_by=b[1], bound_int8_ms=b8[0],
             bound_int8_by=b8[1], bound_popc_ms=bp[0], bound_popc_by=bp[1],
             fill_ms=device_ms(out.zero_), int_mm_ms=None,
             int_mm_call_ms=None)
    if int_mm is not None:
        t.update(int_mm_ms=device_ms(int_mm), int_mm_call_ms=cuda_ms(int_mm))
    ref_txt = ("n/a" if int_mm is None else
               f"{t['int_mm_ms']:.4f} ms ({t['int_mm_call_ms']:.4f})")
    log(f"[time] {name} {label}: kernel {t['ms']:.4f} ms on the device "
        f"({t['call_ms']:.4f} ms for one call with its host time), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms 1-bit tensor "
        f"cores ({t['bound_by']}), {t['bound_int8_ms']:.4f} ms int8 "
        f"({t['bound_int8_by']}), {t['bound_popc_ms']:.4f} ms popcount "
        f"({t['bound_popc_by']}); kernel / bound "
        f"{t['ms'] / t['bound_ms']:.2f}, / int8 bound "
        f"{t['ms'] / t['bound_int8_ms']:.2f}, / popcount bound "
        f"{t['ms'] / t['bound_popc_ms']:.2f}; fill of the output "
        f"{t['fill_ms']:.4f} ms; reference torch._int_mm on "
        f"unpacked +-1 int8 codes {ref_txt}")
    return t


def _pm1_int_mm(q, h):
    """torch._int_mm of the +-1 codes of q [n, w] and h [m, w] (None where
    torch._int_mm does not take the shape), checked against the hamming
    of the full width: dot_pm1 = 32 w - 2 hamming."""
    from repro_torch.core import hdc
    from repro_torch.kernels import ref

    n, w = q.shape
    if n <= 16 or (32 * w) % 8 or h.shape[0] % 8:
        return None
    q_pm1 = hdc.unpack_bits(q, 32 * w)
    h_pm1 = hdc.unpack_bits(h, 32 * w).T

    def fn():
        return torch._int_mm(q_pm1, h_pm1)

    if not torch.equal(fn(), 32 * w - 2 * ref.packed_hamming_ref(q, h)):
        raise AssertionError("torch._int_mm of the +-1 codes != 32 W - 2 H")
    return fn


def _prefix_kernel(cfg, im_w, words, plan_cols, rates):
    """bank_prefix_hamming against its plain version at the hoisted
    S x N_max batch (the prefix step's launch, and the compact step's on
    overflow or at its no-savings tier) at full precision, at the
    ladder's reduced plans through the column selection -- (cap=4,
    planes=2), (8, 1) (W = 64, cap = 8) and (1, 1) (W = 8, cap = 1) -- at
    ragged shapes (W = 40 with cap 1, 5 and 8) and on the adversarial
    inputs; then the step's launch and both reduced plans timed
    (:func:`_hamming_time`). The compact tiers are timed after the compact
    and auto runs (:func:`_prefix_tiers`)."""
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    name = "bank_prefix_hamming"
    N, W, M = STREAMS * cfg.N_max, cfg.words, im_w.shape[0]
    q = words(N, W)
    cases = {
        "main": (q, im_w, cfg.B),
        "plan(planes=2,cap=4)": plan_cols(q, 4, 2) + (4,),
        "plan(8,1): W=64, cap=8": plan_cols(q, 8, 1) + (8,),
        "plan(1,1): W=8, cap=1": plan_cols(q, 1, 1) + (1,),
        "ragged(N=37,M=1000)": (words(37, W), im_w[:1000], cfg.B),
    }
    for cap in (1, 5, 8):
        cases[f"ragged(N=37,M=1001,W=40,cap={cap})"] = (
            words(37, 40), words(1001, 40), cap)
    # 32 W >= 65,536: the kernel stages 32-bit counts
    cases["wide(N=37,M=45,W=2048,cap=8)"] = (words(37, 2048), words(45, 2048),
                                             8)
    for label, (a, b) in _adversarial(words, 45, 77, 40).items():
        for cap in (1, 5, 8):
            cases[f"{label}(N=45,M=77,W=40,cap={cap})"] = (a, b, cap)
    errs = {}
    for label, (qq, hh, cap) in cases.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        got = _one_launch(name, lambda: fw.bank_prefix_hamming(qq, hh,
                                                               cap=cap))
        errs[label] = _check(name, label, got,
                             ref.bank_prefix_hamming_ref(qq, hh, cap=cap))
    by_shape = {}
    for label, (qq, hh, cap) in (
            (f"step(N={N},W={W},cap={cfg.B})", cases["main"]),
            (f"plan(8,1)(N={N},W=64,cap=8)", cases["plan(8,1): W=64, cap=8"]),
            (f"plan(1,1)(N={N},W=8,cap=1)", cases["plan(1,1): W=8, cap=1"])):
        by_shape[label] = _prefix_time(label, qq, hh, cap, rates)
    main = by_shape[f"step(N={N},W={W},cap={cfg.B})"]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/bank_prefix_hamming.cu",
                replaces="src/repro/kernels/fused_window.py:253",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape=f"step(N={N},W={W},cap={cfg.B})",
                **{k: main[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_int8_ms", "bound_popc_ms", "int_mm_ms")},
                by_shape=by_shape)


def _prefix_time(label, q, h, cap, rates):
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    n, w = q.shape
    m = h.shape[0]
    # each input read once, the [n, m, cap] counts written once
    return _hamming_time(
        "bank_prefix_hamming", label,
        lambda: fw.bank_prefix_hamming(q, h, cap=cap),
        lambda: ref.bank_prefix_hamming_ref(q, h, cap=cap),
        4 * (n * w + m * w + n * m * cap), n * m * w, rates,
        _pm1_int_mm(q, h))


def _prefix_tiers(cfg, im_w, tiers, report, rates):
    """bank_prefix_hamming checked and timed at every compact bucket tier
    the compact and auto runs launched (their ``bucket_tier`` telemetry):
    a bucket of ``tier`` rows against the item memory at full precision."""
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cpu").manual_seed(13)
    entry = report["bank_prefix_hamming"]
    log(f"[tiers] compact bucket tiers launched by the compact and auto "
        f"runs: {sorted(tiers)}")
    W = cfg.words
    for tier in sorted(tiers):
        q = torch.randint(-2 ** 31, 2 ** 31 - 1, (tier, W), generator=gen,
                          dtype=torch.int32).to(im_w.device)
        label = f"compact tier(N={tier},W={W},cap={cfg.B})"
        entry["max_abs_err"] = max(entry["max_abs_err"], _check(
            "bank_prefix_hamming", label,
            fw.bank_prefix_hamming(q, im_w, cap=cfg.B),
            ref.bank_prefix_hamming_ref(q, im_w, cap=cfg.B)))
        entry["by_shape"][label] = _prefix_time(label, q, im_w, cfg.B, rates)


def _batched_kernel(cfg, words, dev, rates):
    """packed_hamming_batched against its plain version: the batched
    decide pass's two tables of a step, proposals vs cache snapshot
    [16, 128] x [16, 8] and proposals vs proposals [16, 128] x [16, 128],
    both also pre-masked by the ladder's (1, 1) plan
    (ops.masked_hamming_all zeroes disabled words), ragged shapes (W = 40,
    M = 1 and 5, N = 37), the 2-D form, and the adversarial inputs; then
    each table timed on its own (:func:`_hamming_time`; the int8
    reference is S calls of torch._int_mm, one a stream)."""
    from repro_torch.core import item_memory
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_popcount_sim as xps

    name = "packed_hamming_batched"
    S, Nw, K, W = STREAMS, cfg.N_max, cfg.K, cfg.words
    qb = words(S, Nw, W)
    eb = words(S, K, W)
    wm = item_memory.plan_word_mask(cfg, 1, 1, dev)
    qm, em = torch.where(wm, qb, 0), torch.where(wm, eb, 0)
    snap, prop = f"snapshot([{S},{Nw}]x[{S},{K}])", \
        f"proposals([{S},{Nw}]x[{S},{Nw}])"
    cases = {
        snap: (qb, eb),
        prop: (qb, qb),
        "snapshot, plan(1,1) mask": (qm, em),
        "proposals, plan(1,1) mask": (qm, qm),
        "ragged([3,37]x[3,5],W=40)": (words(3, 37, 40), words(3, 5, 40)),
        "ragged([3,37]x[3,1],W=40)": (words(3, 37, 40), words(3, 1, 40)),
        "ragged([2,37]x[2,8],W=8)": (words(2, 37, 8), words(2, 8, 8)),
        "ragged([2,37]x[2,45],W=13)": (words(2, 37, 13), words(2, 45, 13)),
        "wide([2,37]x[2,45],W=2048)": (words(2, 37, 2048),
                                       words(2, 45, 2048)),
        "2-D [37,40]x[77,40]": (words(37, 40), words(77, 40)),
    }
    for label, (a, b) in _adversarial(words, 37, 8, 40).items():
        cases[f"{label}([1,37]x[1,8],W=40)"] = (a[None], b[None])
    errs = {label: _check(name, label,
                          _one_launch(name, lambda: xps.packed_hamming_batched(
                              qq.contiguous(), hh.contiguous())),
                          ref.packed_hamming_ref(qq.contiguous(),
                                                 hh.contiguous()))
            for label, (qq, hh) in cases.items()}
    by_shape = {}
    for label in (snap, prop):
        qq, hh = cases[label]
        m = hh.shape[1]
        mms = [_pm1_int_mm(qq[s], hh[s]) for s in range(S)]
        by_shape[label] = _hamming_time(
            name, label, lambda: xps.packed_hamming_batched(qq, hh),
            lambda: ref.packed_hamming_ref(qq, hh),
            4 * (S * Nw * W + S * m * W + S * Nw * m), S * Nw * m * W, rates,
            None if None in mms else (lambda: [f() for f in mms]))
    main = by_shape[prop]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/packed_hamming_batched.cu",
                replaces="src/repro/kernels/xnor_popcount_sim.py:130",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape=prop,
                **{k: main[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_int8_ms", "bound_popc_ms", "int_mm_ms")},
                by_shape=by_shape)


def _one_launch(name, fn):
    """``fn()`` with the check that it launched ``name`` exactly once."""
    from repro_torch.kernels import build

    before = build.LAUNCHES[name]
    out = fn()
    if build.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: {build.LAUNCHES[name] - before} "
                             "launches for one call")
    return out


def _fused_scores_kernel(cfg, im_w, words, plan_cols, rates):
    """fused_scores against its plain version at one window's proposals
    (N = N_max, the switch step's launch) and one engine step's
    (N = S x N_max, the batched switch lowering's widest launch) at the
    widest plan, at reduced plans, ragged M and W, M = 1 (top2[1] =
    INT32_MIN), and three tie patterns: copies 512 classes apart, adjacent
    copies (one class tile) and a copy in every FS_CLASS_TILE-class tile
    (each tile of the kernel's class split holds the tied maximum); the
    first copy must win and top2[1] == top2[0]. Then both N timed two ways
    (a CUDA graph of 20 calls, and one call with its host time) beside the
    plain version, the int8 tensor-core bound (``bound_ms``: the kernel's
    products run there), the popcount bound (``bound_popc_ms``), and the
    int8 product torch._int_mm on the unpacked +-1 operands (a reference
    that reads 8x the bytes, not a library call of the same function)."""
    from repro_torch.core import hdc
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    Nw, W, M = cfg.N_max, cfg.words, im_w.shape[0]
    rows = (Nw, STREAMS * Nw)
    qs = {n: words(n, W) for n in rows}
    qw, half, T = qs[Nw], M // 2, FS_CLASS_TILE
    # label: (item memory, classes the first copy of each tie lies under,
    # or 2 for adjacent copies: the first copy's index is even)
    ties = {
        f"tied(copies {half} apart)": (
            torch.cat([im_w[:half], im_w[:half]]), half),
        "tied(adjacent copies, one class tile)": (
            im_w[:half].repeat_interleave(2, dim=0), 2),
        f"tied(a copy in every {T}-class tile)": (
            im_w[:T].repeat(M // T, 1), T),
    }
    cases = {
        f"main(N={n},b=8)": (qs[n], im_w) for n in rows}
    cases.update({
        "reduced(b=2)": (qw[:, :2 * cfg.bank_words], im_w[:, :2 * cfg.bank_words]),
        "plan(4,1): W=32": plan_cols(qw, 4, 1),
        "plan(1,1): W=8": plan_cols(qw, 1, 1),
        "ragged(N=37,M=1000,W=96)": (words(37, 96), im_w[:1000, :96]),
        "ragged(N=128,M=1001,W=37)": (qw[:, :37], im_w[:1001, :37]),
        "M=1": (qw, im_w[:1]),
    })
    cases.update({k: (qw, v[0]) for k, v in ties.items()})
    errs = {}
    for label, (qq, hh) in cases.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        d_eff = 32 * qq.shape[1]
        got = _one_launch("fused_scores",
                          lambda: fw.fused_scores(qq, hh, d_eff=d_eff))
        errs[label] = _check("fused_scores", label, got,
                             ref.fused_scores_ref(qq, hh, d_eff=d_eff))
        if label in ties:
            under = ties[label][1]
            first = (got[1] % 2 == 0) if under == 2 else (got[1] < under)
            if not (bool(first.all())
                    and torch.equal(got[2][:, 0], got[2][:, 1])):
                raise AssertionError(f"fused_scores {label}: ties not "
                                     "resolved to the first copy")
        if label == "M=1" and not (bool((got[1] == 0).all()) and bool(
                (got[2][:, 1] == ref.INT32_MIN).all())):
            raise AssertionError("fused_scores M=1: best != 0 or "
                                 "top2[1] != INT32_MIN")
    by_rows = {}
    for n in rows:
        q = qs[n]
        q_pm1 = hdc.unpack_bits(q, 32 * W)
        im_pm1 = hdc.unpack_bits(im_w, 32 * W)

        def fn():
            return fw.fused_scores(q, im_w, d_eff=cfg.D)

        def int_mm():
            return torch._int_mm(q_pm1, im_pm1.T)

        # the int8 product of the +-1 codes is acc - (d_eff - 32 W)
        if not torch.equal(int_mm() + (cfg.D - 32 * W), fn()[0]):
            raise AssertionError("torch._int_mm of the +-1 codes != acc")
        moved = 4 * (n * W + M * W + n * M + 3 * n)
        b = bound(moved, 2 * n * M * 32 * W / PEAK_INT8_S)
        bp = bound(moved, rates.popc_s(n * M * W))
        t = dict(ms=device_ms(fn), call_ms=cuda_ms(fn),
                 plain_ms=cuda_ms(lambda: ref.fused_scores_ref(
                     q, im_w, d_eff=cfg.D)),
                 bound_ms=b[0], bound_by=b[1], bound_popc_ms=bp[0],
                 bound_popc_by=bp[1], int_mm_ms=device_ms(int_mm),
                 int_mm_call_ms=cuda_ms(int_mm))
        by_rows[str(n)] = t
        log(f"[time] fused_scores(N={n},M={M},W={W}): kernel {t['ms']:.4f} "
            f"ms on the device ({t['call_ms']:.4f} ms for one call with its "
            f"host time), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms int8 tensor cores ({t['bound_by']}), "
            f"{t['bound_popc_ms']:.4f} ms popcount ({t['bound_popc_by']}); "
            f"reference torch._int_mm on unpacked +-1 int8 operands "
            f"[{n},{32 * W}] x [{32 * W},{M}] (8x the bytes) "
            f"{t['int_mm_ms']:.4f} ms ({t['int_mm_call_ms']:.4f}); kernel / "
            f"int8 bound {t['ms'] / t['bound_ms']:.2f}, kernel / popcount "
            f"bound {t['ms'] / t['bound_popc_ms']:.2f}, kernel / "
            f"torch._int_mm {t['ms'] / t['int_mm_ms']:.2f}")
    main = by_rows[str(Nw)]
    return dict(name="fused_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_scores.cu",
                replaces="src/repro/kernels/fused_window.py:141",
                max_abs_err=max(errs.values()), library_ms=None,
                **{k: main[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "call_ms",
                    "bound_popc_ms", "int_mm_ms")},
                by_rows=by_rows)


def _delta_rows(L, K, nnz, D, gen):
    """idx, weight int32 [L, K] laid out as ``aligner.delta_indices`` lays
    them out: row l's first nnz[l] entries carry weight +-2 at ascending
    distinct dims, the rest are padding (index 0, weight 0)."""
    idx = torch.zeros((L, K), dtype=torch.int32)
    w = torch.zeros((L, K), dtype=torch.int32)
    for r, n in enumerate(nnz):
        idx[r, :n] = torch.randperm(D, generator=gen)[:n].sort().values
        w[r, :n] = torch.randint(0, 2, (n,), generator=gen) * 4 - 2
    return idx, w


def _delta_bound(idx, w, M, D, rates):
    """bytes: the distinct dmajor rows the nonzero weights need, idx and w,
    acc in and out; operations: one multiply-add per nonzero entry and
    column on the 64-wide integer pipe."""
    nz = w != 0
    ix = idx[nz]
    rows = int(torch.unique(torch.where(ix < 0, ix + D, ix).clamp(0, D - 1))
               .numel())
    L, K = idx.shape
    return bound(rows * M + 8 * L * K + 8 * L * M,
                 rates.int32_s(int(nz.sum()) * M))


def _delta_time(label, args, rates):
    """delta_update at ``args`` timed two ways beside the plain version and
    the bound of this fill; logs and returns the times."""
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import ref

    acc, dmajor, idx, w = args
    b = _delta_bound(idx, w, dmajor.shape[1], dmajor.shape[0], rates)
    t = dict(ms=device_ms(lambda: du.delta_update(*args)),
             call_ms=cuda_ms(lambda: du.delta_update(*args)),
             plain_ms=cuda_ms(lambda: ref.delta_update_ref(*args)),
             bound_ms=b[0], bound_by=b[1],
             nonzero=int((w != 0).sum()))
    log(f"[time] delta_update {label}: kernel {t['ms']:.4f} ms on the "
        f"device ({t['call_ms']:.4f} ms for one call with its host time), "
        f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); kernel / bound {t['ms'] / t['bound_ms']:.2f}")
    return t


def _delta_check(label, args):
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import ref

    return _check("delta_update", label,
                  _one_launch("delta_update", lambda: du.delta_update(*args)),
                  ref.delta_update_ref(*args))


def _delta_fill(L, nnz, cfg, dmajor, gen, pad_row=False):
    """(acc, dmajor, idx, w) with L rows of nnz weighted entries each of
    the edge budget (the last row all padding with ``pad_row``)."""
    dev = dmajor.device
    M, D, K = dmajor.shape[1], dmajor.shape[0], cfg.delta_budget
    counts = [nnz] * L
    if pad_row:
        counts[-1] = 0
    idx, w = _delta_rows(L, K, counts, D, gen)
    acc = torch.randint(-4000, 4000, (L, M), generator=gen,
                        dtype=torch.int32)
    return acc.to(dev), dmajor, idx.to(dev), w.to(dev)


def _delta_update_kernel(cfg, dmajor, gen, rates):
    """delta_update against its plain version: the serial switch step's
    launch shape (L = 1 row: one proposal of one stream) and the batched
    switch lowering's (L = 16, one proposal of every stream), each with the
    whole budget weighted (a proposal whose flip count reaches it) and with
    one weighted entry (at L = 16 the last row all padding), all timed; the
    L = 16 input of the earlier slices (half of each row padding, every
    fifth row all padding; timed too), a ragged M (no vector loads), an
    all-padding row, indices out of range with weight (a negative one
    wrapped from the end once, then every one clamped to [0, D), as JAX's
    gather takes them: -1, -5, -D, -D - 3, D + 6 among them), K = 1 and K = 1001 (not a multiple of the
    kernel's budget split). The fill that the serial switch run's launches
    see most is timed after that run (:func:`_delta_median`)."""
    dev = dmajor.device
    L, Kb, D, M = STREAMS, cfg.delta_budget, cfg.D, dmajor.shape[1]
    acc = torch.randint(-4000, 4000, (L, M), generator=gen,
                        dtype=torch.int32).to(dev)
    idx = torch.randint(0, D, (L, Kb), generator=gen,
                        dtype=torch.int32).to(dev)
    wts = (torch.randint(0, 2, (L, Kb), generator=gen,
                         dtype=torch.int32) * 4 - 2)
    wts[:, Kb // 2:] = 0
    wts[::5] = 0
    wts = wts.to(dev)
    main = (acc, dmajor, idx, wts)
    oor_idx, oor_w = idx[:2].clone(), wts[:2].clone()
    oor_idx[0, :3] = torch.tensor([-5, D + 100, 2 ** 31 - 1])
    oor_w[0, :3] = torch.tensor([2, -2, 2])
    oor_idx[1, -1], oor_w[1, -1] = -(2 ** 31), -2
    neg_idx, neg_w = idx[:2].clone(), wts[:2].clone()
    neg_idx[0, :5] = torch.tensor([-1, -5, -D, -D - 3, D + 6])
    neg_w[0, :5] = torch.tensor([2, -2, 2, -2, 2])
    neg_idx[1, -5:] = torch.tensor([-1, -5, -D, -D - 3, D + 6])
    neg_w[1, -5:] = torch.tensor([-2, 2, -2, 2, -2])
    timed = {f"L={n},nnz={k}": _delta_fill(n, k, cfg, dmajor, gen,
                                           pad_row=(n > 1 and k == 1))
             for n in (1, L) for k in (Kb, 1)}
    cases = {"main(L=16,budget=2048)": main,
             "ragged(M=1001)": (acc[:, :1001].contiguous(),
                                dmajor[:, :1001].contiguous(), idx, wts),
             "L=1, all padding": _delta_fill(1, 0, cfg, dmajor, gen),
             "indices out of range, weighted": (acc[:2].contiguous(), dmajor,
                                                oor_idx, oor_w),
             "negative indices -1, -5, -D, -D-3 and D+6, weighted": (
                 acc[:2].contiguous(), dmajor, neg_idx, neg_w),
             "K=1": (acc, dmajor, idx[:, :1].contiguous(),
                     torch.where(wts[:, :1] == 0, 2, wts[:, :1]).contiguous()),
             "K=1001": (acc, dmajor, idx[:, :1001].contiguous(),
                        torch.where(wts[:, :1001] == 0, 2,
                                    wts[:, :1001]).contiguous())}
    cases.update(timed)
    errs = {label: _delta_check(label, args) for label, args in cases.items()}
    by_shape = {label: _delta_time(label, args, rates)
                for label, args in timed.items()}
    by_shape["main(L=16,budget=2048)"] = _delta_time(
        "main(L=16,budget=2048)", main, rates)
    first = by_shape["L=1,nnz=2048"]
    return dict(name="delta_update", route="cuda",
                source="src/repro_torch/kernels/csrc/delta_update.cu",
                replaces="src/repro/kernels/delta_update.py:37",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape="L=1,nnz=2048",
                **{k: first[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                by_shape=by_shape)


def _delta_fill_counts(cfg, frames, res):
    """Weighted entries of the ``delta_update`` row each valid proposal of
    an engine run launches: ``delta_indices`` weights the first
    min(|Delta|, budget) entries, and the telemetry keeps |Delta|. Padding
    proposals launch too, but their |Delta| is not kept (it reads 0)."""
    counts = [np.minimum(tel.delta_count.cpu().numpy()[fr[t].valid],
                         cfg.delta_budget)
              for s, fr in enumerate(frames)
              for t, (_, tel) in enumerate(res[f"cam{s}"])]
    return torch.from_numpy(np.concatenate(counts))


def _delta_median(cfg, dmajor, counts, report, rates):
    """Print the distribution of weighted entries per row over the serial
    switch run's proposals' delta_update launches, then check and time the
    kernel at the median fill at L = 1 (the launch shape of that run, now
    the report's main shape) and L = 16."""
    if counts.numel() == 0:
        raise AssertionError("serial switch run: no proposal")
    c = counts.to(torch.float64)
    q = [int(torch.quantile(c, p)) for p in (0.0, 0.1, 0.25, 0.5, 0.75,
                                              0.9, 1.0)]
    med = q[3]
    log(f"[delta fill] serial switch run: {counts.numel()} proposals' rows "
        f"of {cfg.delta_budget} budget entries; weighted entries per row "
        f"min/p10/p25/median/p75/p90/max {q}; rows with no weighted entry "
        f"{int((counts == 0).sum())}, rows with the whole budget weighted "
        f"{int((counts == cfg.delta_budget).sum())}")
    gen = torch.Generator(device="cpu").manual_seed(12)
    entry = report["delta_update"]
    for n in (1, STREAMS):
        label = f"L={n},nnz={med} (median)"
        args = _delta_fill(n, med, cfg, dmajor, gen)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   _delta_check(label, args))
        entry["by_shape"][label] = _delta_time(label, args, rates)
    main = entry["by_shape"][f"L=1,nnz={med} (median)"]
    entry.update(main_shape=f"L=1,nnz={med} (median)",
                 **{k: main[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by")})
    entry["fill_quantiles"] = q


def _encode_bounds(n, d, D, out_bytes):
    """(3xTF32 bound, FP32-FMA bound) of sign(z @ R.T) for n rows: z and R
    read once, the codes written once; the 3xTF32 product is three TF32
    products on the tensor cores, the FP32 one an FMA (2 operations) per
    term on the CUDA cores."""
    moved = 4 * (n * d + D * d) + out_bytes
    return (bound(moved, 3 * 2 * n * D * d / PEAK_TF32_S),
            bound(moved, 2 * n * D * d / PEAK_FP32_S))


def _encode_kernels(cfg, gen, dev, N):
    """sign_project_pack and sign_project: the agreement rule (no decided
    code may differ) at every timed shape and at a ragged one whose all-zero
    and NaN rows must equal the plain version exactly; one launch per call;
    then each timed at 8 rows (the benchmark caller's), N_max rows (one
    window) and N (one engine step, the main shape) beside the plain
    version, the FP32 product torch.matmul(z, R.T) (TF32 off) and both
    bounds."""
    from repro_torch.core import hdc
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_project as sp

    d, D = cfg.feat_dim, cfg.D
    rows = (8, cfg.N_max, N)
    z = torch.randn((N, d), generator=gen).to(dev)
    R = (torch.randn((D, d), generator=gen) / np.sqrt(d)).to(dev)
    zr = torch.randn((37, d), generator=gen).to(dev)
    zr[5] = 0.0                      # y = +-0: every code +1
    zr[9, 100] = float("nan")        # y NaN: every code -1
    Rr = R[:8160].contiguous()
    kernels = {
        "sign_project_pack": dict(
            fn=fw.sign_project_pack, plain=ref.sign_project_pack_ref,
            rule=ref.sign_pack_disagreement, out_bytes=lambda n: n * D // 8,
            codes=lambda w, DD: hdc.unpack_bits(w, DD).to(torch.int32),
            replaces="src/repro/kernels/fused_window.py:382"),
        "sign_project": dict(
            fn=sp.sign_project, plain=ref.sign_project_ref,
            rule=ref.sign_disagreement, out_bytes=lambda n: n * D,
            codes=lambda c, DD: c.to(torch.int32),
            replaces="src/repro/kernels/sign_project.py:30"),
    }
    report = {}
    for name, k in kernels.items():
        shapes = {f"N={n}": (z[:n].contiguous(), R) for n in rows}
        shapes["ragged(N=37,D=8160), zero row 5, NaN row 9"] = (zr, Rr)
        errs = {}
        for label, (zz, RR) in shapes.items():
            got = _one_launch(name, lambda: k["fn"](zz, RR))
            want = k["plain"](zz, RR)
            torch.cuda.synchronize()
            rule = k["rule"](zz, RR, got, want)
            err = int((k["codes"](got, RR.shape[0])
                       - k["codes"](want, RR.shape[0])).abs().max())
            errs[label] = err
            log(f"[kernel] {name} {label}: bits {rule['bits']} "
                f"decided_differ {rule['decided_differ']} undecided_differ "
                f"{rule['undecided_differ']} max_abs_err {err}")
            if not rule["ok"] or rule["decided_differ"] != 0 or \
                    got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label} breaks the agreement "
                                     f"rule {rule}")
            if label.startswith("ragged"):
                for row in (5, 9):
                    if not torch.equal(got[row], want[row]):
                        raise AssertionError(f"{name}: row {row} differs "
                                             "from the plain version")
        by_n = {}
        for n in rows:
            zz = z[:n].contiguous()
            b, b32 = _encode_bounds(n, d, D, k["out_bytes"](n))
            fn, plain = k["fn"], k["plain"]
            t = dict(
                ms=device_ms(lambda: fn(zz, R)),
                call_ms=cuda_ms(lambda: fn(zz, R)),
                plain_ms=cuda_ms(lambda: plain(zz, R)),
                library_ms=device_ms(lambda: torch.matmul(zz, R.T)),
                library_call_ms=cuda_ms(lambda: torch.matmul(zz, R.T)),
                bound_ms=b[0], bound_by=b[1], bound_fp32_ms=b32[0],
                bound_fp32_by=b32[1])
            by_n[n] = t
            log(f"[time] {name}(N={n}): kernel {t['ms']:.4f} ms on the device "
                f"({t['call_ms']:.4f} ms for one call with its host time), "
                f"torch.matmul {t['library_ms']:.4f} ms "
                f"({t['library_call_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms 3xTF32 ({t['bound_by']}), "
                f"{t['bound_fp32_ms']:.4f} ms FP32 ({t['bound_fp32_by']}); "
                f"kernel / matmul {t['ms'] / t['library_ms']:.3f}")
        main = by_n[N]
        report[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=k["replaces"], max_abs_err=errs[f"N={N}"],
            **{key: main[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "call_ms", "library_call_ms", "bound_fp32_ms")},
            by_rows={str(n): t for n, t in by_n.items()})
    return report


# --- serving ----------------------------------------------------------------

# the lowering encodings (core.types FUSED_IDS / DECIDE_IDS) each engine's
# telemetry must carry
FUSED_PREFIX, FUSED_SWITCH, FUSED_COMPACT = 2, 1, 3
DECIDE_SCAN, DECIDE_BATCHED, DECIDE_NONE = 0, 1, -1
LOWERING_FIELDS = ("fused_mode", "decide_mode", "bucket_tier")


def _serve_card(cfg, sys_, frames, report, label, steps=None, words=None,
                warm=True, **engine_kw):
    """Serve ``frames`` (S streams in S slots) through an engine on the
    card: features -> ``encode_packed`` (or the given per-step ``words``)
    -> ``submit`` -> ``step`` -> ``sync`` (all of them, or the first
    ``steps``), each step timed on the host clock up to its sync, with
    every kernel's launches counted from zero around the run. ``warm``
    runs the engine's warm-up first (with ``jit`` it captures the first
    key). Returns the engine, its per-stream results, the state after each
    step, each step's packed words, the launch counts and the step times
    in ms."""
    from repro_torch.kernels import build
    from repro_torch.perf.profile_step import encode_step, submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S, T = len(frames), len(frames[0])
    R = torch.as_tensor(sys_.R).cuda()
    eng = StreamEngine(cfg, sys_.im, n_slots=S, **engine_kw)
    t0 = time.perf_counter()
    if warm:
        eng.warmup()
    eng.sync()
    warm_s = time.perf_counter() - t0
    build.reset_launches()
    t0 = time.perf_counter()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    encode = words is None
    words = [] if encode else words
    for t in range(T):    # one encode call per step's windows
        if encode:
            words.append(encode_step(frames, t, R))
        submit_step(eng, frames, t, words[t])
    res = {f"cam{s}": [] for s in range(S)}
    states, step_ms = [], []
    # each stream's backlog is its queue depth
    while eng.busy and (steps is None or len(states) < steps):
        t1 = time.perf_counter()
        out = eng.step()
        eng.sync()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        for sid, r in out.items():
            res[sid].append(r)
        states.append(eng.state)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    # each graph's segment, host value and kernel nodes
    nodes = {f"{k[0]}{list(k[5:])}": eng.graphs.entry(k).kernel_nodes
             for k in (eng.graphs.keys() if eng.graphs else ())}
    log(f"[{label}] {torch.cuda.get_device_name(0)}: {eng.stats.windows} "
        f"windows in {wall:.3f} s = {eng.stats.windows / wall:.1f} "
        f"windows/s, {1e3 * wall / eng.stats.steps:.1f} ms/step (encode "
        f"included); steps alone {[round(x, 2) for x in step_ms]} ms; "
        f"warm-up {warm_s:.3f} s; graphs (kernel nodes) {nodes}; launches "
        f"{launches}")
    for name, n in launches.items():
        if name in report and "launches" not in report[name] and n > 0:
            report[name]["launches"] = n
    return eng, res, states, words, launches, step_ms


def _captured_run(runs, label, res, cache, step_ms, graphs, eager, row=None):
    """Record a captured run for :func:`phase_eager`: its results, final
    cache, step times and graph count, and ``eager``, which runs the same
    thing with ``jit=False`` and returns (results, final cache, step ms)."""
    runs.append(dict(label=label, res=res, cache=cache,
                     ms=statistics.median(step_ms), graphs=graphs,
                     eager=eager, row=row))


def _eager_serve(cfg, sys_, frames, label, words, steps=None, **engine_kw):
    """:func:`_serve_card` of the same words on ``StreamEngine(jit=False)``
    (no warm-up: the kernels are built)."""
    def run():
        eng, res, _states, _words, _launches, ms = _serve_card(
            cfg, sys_, frames, {}, f"{label}, eager", steps=steps,
            words=words, warm=False, jit=False, **engine_kw)
        return res, eng.state.cache, ms
    return run


def _require_launched(label, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")


def _path_mix(frames, res):
    """Valid proposals after each stream's first window, by path (pad
    proposals report bypass, so only valid ones count)."""
    from repro_torch.core.types import PATH_NAMES

    mix = dict.fromkeys(PATH_NAMES, 0)
    for s, fr in enumerate(frames):
        for t, (_, tel) in enumerate(res[f"cam{s}"][1:], start=1):
            path = tel.path.cpu().numpy()[fr[t].valid]
            for i, name in enumerate(PATH_NAMES):
                mix[name] += int((path == i).sum())
    return mix


def _assert_results_equal(label, res, ref_res, skip=()):
    """Per-stream outputs and telemetry bit-equal, field by field, for the
    windows ``res`` holds (``skip`` names telemetry fields checked apart)."""
    for sid, wins in res.items():
        for t, ((o, tel), (oc, telc)) in enumerate(zip(wins, ref_res[sid])):
            for obj, objc in ((o, oc), (tel, telc)):
                for f in dataclasses.fields(obj):
                    if f.name in skip:
                        continue
                    if not bits_equal(getattr(obj, f.name),
                                      getattr(objc, f.name)):
                        raise AssertionError(
                            f"{label} {sid} window {t}: "
                            f"{type(obj).__name__}.{f.name} differs")


def _assert_caches_equal(label, cache, ref_cache):
    for f in dataclasses.fields(cache):
        if not bits_equal(getattr(cache, f.name), getattr(ref_cache, f.name)):
            raise AssertionError(f"{label} final cache.{f.name} differs")


def _cpu_engine(cfg, sys_, frames, words, n, plan=None):
    """The engine on the CPU (plain versions), fed the card's packed words
    (the same backlog) under the same latched ``plan``, over its first
    ``n`` steps: (per-stream results, final cache, seconds)."""
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    t0 = time.perf_counter()
    S = len(frames)
    cpu = StreamEngine(cfg, sys_.im, n_slots=S, device="cpu")
    cpu.set_plan(plan)
    for s in range(S):
        cpu.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    for t, w in enumerate(words):
        submit_step(cpu, frames, t, w.cpu())
    res_cpu = {f"cam{s}": [] for s in range(S)}
    for _ in range(n):
        for sid, r in cpu.step().items():
            res_cpu[sid].append(r)
    return res_cpu, cpu.state.cache, time.perf_counter() - t0


def _cpu_engine_process(out_path, *args):
    """:func:`_cpu_engine` in a spawned process (the CPU only), its
    result pickled to ``out_path``."""
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)
    with open(out_path, "wb") as f:
        pickle.dump(_cpu_engine(*args), f)


def _start_cpu_engine(cfg, sys_, frames, words, n):
    """:func:`_cpu_engine` started in a process of its own, so the card's
    phases go on beside it (it is host-bound Python, about 100 s)."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "cpu_engine.pkl")
    proc = mp.get_context("spawn").Process(
        target=_cpu_engine_process,
        args=(out, cfg, sys_, frames, [w.cpu() for w in words], n),
        daemon=True)
    proc.start()
    return proc, tmp, out


def _cpu_engine_result(started):
    """The result of :func:`_start_cpu_engine` (waiting at most
    CPU_ENGINE_LIMIT_S for it; a failed or late process fails the run)."""
    import pickle

    proc, tmp, out = started
    try:
        proc.join(timeout=CPU_ENGINE_LIMIT_S)
        if proc.is_alive() or proc.exitcode != 0:
            raise AssertionError(f"the CPU reference engine's process "
                                 f"failed (exit {proc.exitcode})")
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
        tmp.cleanup()


def _equal_to_cpu(label, res, states, n, cpu_run):
    """The card engine's first ``n`` steps (``res``, ``states``) bit-equal
    to the CPU engine's (``cpu_run``, :func:`_cpu_engine`'s result) in
    outputs, telemetry and caches."""
    res_cpu, cache_cpu, secs = cpu_run
    log(f"[{label}] cpu reference engine, {n} windows: {secs:.1f} s")
    for sid, wins in res_cpu.items():
        if len(wins) != n:
            raise AssertionError(f"{label} {sid}: {len(wins)} windows")
    _assert_results_equal(label, res_cpu, res)
    _assert_caches_equal(label, states[n - 1].cache, cache_cpu)
    log(f"[{label}] card engine == CPU engine over {n} windows: outputs, "
        f"telemetry and caches bit-equal")


def phase_serving(cfg, sys_, frames, report, label, cpu_windows, runs,
                  checks):
    """The multi-stream step's default (prefix) lowering on the card, its
    first ``cpu_windows`` windows to be held bit-equal to the CPU engine,
    which starts in a process of its own (``checks`` gets the check, to
    run once it has ended); returns its results and the state after each
    step for the other lowerings to be held to, and its packed words;
    records the run for :func:`phase_eager`."""
    eng, res, states, words, launches, step_ms = _serve_card(
        cfg, sys_, frames, report, label)
    _require_launched(label, launches,
                      ("bank_prefix_hamming", "sign_project_pack"))
    n_valid = [int(f.valid.sum()) for fr in frames for f in fr]
    log(f"[{label}] valid proposals per window {min(n_valid)}-"
        f"{max(n_valid)} (cache depth K={cfg.K}); after each stream's first "
        f"window, by path: {_path_mix(frames, res)}")
    for sid, wins in res.items():
        if len(wins) != len(frames[0]):
            raise AssertionError(f"{label} {sid}: {len(wins)} windows")
        for out, tel in wins:
            if out.scores.shape != (cfg.N_max, cfg.M) or \
                    not bool(torch.isfinite(out.scores).all()):
                raise AssertionError(f"{sid}: bad scores")
            if int(tel.fused_mode) != FUSED_PREFIX:
                raise AssertionError(f"{sid}: fused_mode {tel.fused_mode}")
    started = _start_cpu_engine(cfg, sys_, frames, words, cpu_windows)
    checks.append(lambda: _equal_to_cpu(label, res, states, cpu_windows,
                                        _cpu_engine_result(started)))
    _captured_run(runs, label, res, eng.state.cache, step_ms, len(eng.graphs),
                  _eager_serve(cfg, sys_, frames, label, words))
    return res, states, words


def phase_lowering(cfg, sys_, frames, report, label, base, kernels,
                   lowerings, runs, n_windows=None, **engine_kw):
    """An engine on another lowering, held bit-equal to the card's prefix
    engine (``base`` = its results and per-step states) in every field but
    the lowering encodings, which must be one of ``lowerings`` (tuples of
    fused_mode, decide_mode, bucket tier or None for any compact tier),
    over the first ``n_windows`` steps (all by default); the run is
    recorded for :func:`phase_eager`. Returns the per-step encodings and
    the engine's per-stream results."""
    base_res, base_states, _words = base
    eng, res, states, words, launches, step_ms = _serve_card(
        cfg, sys_, frames, report, label, steps=n_windows, **engine_kw)
    _captured_run(runs, label, res, eng.state.cache, step_ms, len(eng.graphs),
                  _eager_serve(cfg, sys_, frames, label, words,
                               steps=n_windows, **engine_kw))
    _require_launched(label, launches, kernels)
    _assert_results_equal(label, res, base_res, skip=LOWERING_FIELDS)
    _assert_caches_equal(label, eng.state.cache,
                         base_states[len(states) - 1].cache)
    rows = len(frames) * cfg.N_max
    seen = []                     # per step: every stream's encodings
    for t in range(len(states)):
        encs = {tuple(int(getattr(wins[t][1], f)) for f in LOWERING_FIELDS)
                for wins in res.values()}
        enc = encs.pop()
        if encs or not any(enc[:2] == low[:2] and (
                enc[2] == low[2] if low[2] is not None
                else 0 < enc[2] < rows) for low in lowerings):
            raise AssertionError(f"{label} step {t}: lowering encodings "
                                 f"{encs | {enc}} not one of {lowerings}")
        seen.append(enc)
    log(f"[{label}] == card prefix engine in every field; lowering "
        f"(fused, decide, tier) per step: {seen}; path mix after the first "
        f"windows: {_path_mix(frames, res)}")
    return seen, res


def phase_evaluate(cfg, world, sys_):
    """evaluate_task for the five tasks on the card; one task's per-frame
    scores and telemetry equal to the same run on the CPU fed the card's
    packed queries."""
    from repro_torch.data import tood_synth as ts
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving import tood_pipelines as tp

    build.reset_launches()
    t0 = time.perf_counter()
    results = [tp.evaluate_task(world, sys_, t, n_frames=EVAL_FRAMES, seed=0)
               for t in range(len(ts.TASKS))]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"[evaluate] {len(results)} tasks x {EVAL_FRAMES} frames on the "
        f"card in {time.perf_counter() - t0:.1f} s; launches {launches}")
    _require_launched("evaluate", launches,
                      ("fused_scores", "delta_update", "sign_project_pack"))
    for r in results:
        mix = {k: round(v, 4) for k, v in r["path_mix"].items()}
        log(f"[evaluate] {r['task']}: AP@0.5 torr {r['ap_torr']:.2f} dense "
            f"{r['ap_dense']:.2f} naive_hdc {r['ap_naive_hdc']:.2f}; path "
            f"mix {mix}")
        if not all(np.isfinite([r["ap_torr"], r["ap_dense"],
                                r["ap_naive_hdc"]])):
            raise AssertionError(f"{r['task']}: AP not finite")
    # task 0 again on the CPU, fed the card's packed queries (the encode
    # is held to the CPU's by its agreement rule, not bit for bit: a code
    # whose |y| is within rounding of zero may differ), the rest of the
    # pipeline bit for bit
    t0 = time.perf_counter()
    frames = ts.simulate_sequence(world, 0, EVAL_FRAMES, 0,
                                  n_max=cfg.N_max)
    R = torch.from_numpy(np.array(sys_.R, np.float32))
    words = []
    for t, f in enumerate(frames):
        card = ops.encode_packed(f.feats, R.cuda()).cpu()
        z = torch.from_numpy(np.array(f.feats, np.float32))
        rule = ref.sign_pack_disagreement(
            z, R, card, ops.encode_packed(f.feats, R, device="cpu"))
        log(f"[evaluate] task 0 frame {t} encode, card vs CPU: "
            f"decided_differ {rule['decided_differ']} undecided_differ "
            f"{rule['undecided_differ']} of {rule['bits']}")
        if not rule["ok"] or rule["decided_differ"]:
            raise AssertionError(f"evaluate task 0 frame {t}: the card's "
                                 f"encode breaks the agreement rule {rule}")
        words.append(card)
    scores, tels = tp.run_torr(sys_, frames, 0, device="cpu", words=words)
    for t in range(EVAL_FRAMES):
        if not np.array_equal(scores[t].view(np.int32),
                              results[0]["scores"][t].view(np.int32)):
            raise AssertionError(f"evaluate task 0 frame {t}: scores differ "
                                 "between the card and the CPU")
        for f in dataclasses.fields(tels[t]):
            if not bits_equal(getattr(tels[t], f.name),
                              getattr(results[0]["telemetry"][t], f.name)):
                raise AssertionError(f"evaluate task 0 frame {t}: "
                                     f"telemetry {f.name} differs")
    log(f"[evaluate] task 0 on the CPU from the card's encodes "
        f"({time.perf_counter() - t0:.1f} s): per-frame scores and telemetry "
        f"bit-equal to the card's")


def phase_sign_project(sys_, frames, report):
    """The int8 encode entry point ``ops.sign_project`` on the first step's
    proposal features of every stream (S x N_max rows) and at its
    benchmark caller's shape (8 rows), with its launches counted; held to
    the plain version by the agreement rule. No serving path runs it."""
    from repro_torch.kernels import build, ops, ref

    R = torch.as_tensor(sys_.R).cuda()
    feats = np.stack([fr[0].feats for fr in frames])
    feats = feats.reshape(-1, feats.shape[-1])
    build.reset_launches()
    codes = [ops.sign_project(x, R) for x in (feats, feats[:8])]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    _require_launched("sign_project entry", launches, ("sign_project",))
    report["sign_project"]["launches"] = launches["sign_project"]
    for x, c in zip((feats, feats[:8]), codes):
        z = torch.from_numpy(np.array(x, np.float32)).cuda()
        rule = ref.sign_disagreement(z, R, c, ref.sign_project_ref(z, R))
        log(f"[sign_project entry] ops.sign_project {tuple(c.shape)} int8: "
            f"decided_differ {rule['decided_differ']} undecided_differ "
            f"{rule['undecided_differ']}")
        if not rule["ok"]:
            raise AssertionError(f"ops.sign_project breaks the agreement "
                                 f"rule {rule}")
    log(f"[sign_project entry] launches {launches}")


def _device_busy_ms(fn) -> float:
    """Run ``fn`` (work that ends in a synchronize) under torch.profiler,
    device activity only, and return the summed duration of its device
    events in ms. The raw kineto events are summed as they come: building
    the profiler's Python event tree (``key_averages``, which gives the same
    total) costs seconds for a step of 31k launches."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return busy


def _timed_steps(n, one, profile):
    """Run ``one(t)`` for t < n, timing each on the host clock (``one``
    ends in a synchronize); with ``profile`` the last run is under
    torch.profiler instead and gives only the device busy ms."""
    step_ms, busy = [], None
    for t in range(n):
        if profile and t == n - 1:
            busy = _device_busy_ms(lambda: one(t))
        else:
            t0 = time.perf_counter()
            one(t)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    return step_ms, busy


def _serve_words(cfg, sys_, frames, words, plan, profile, **engine_kw):
    """Serve pre-encoded ``words`` (one [S x N_max, W] tensor per window,
    all submitted first) through an engine on the card with ``plan``
    latched, launches counted from zero. Returns its results, the state
    after each step, the launches, the host ms of each timed step, the
    device busy ms of the profiled one (see :func:`_timed_steps`) and the
    engine's graph count."""
    from repro_torch.kernels import build
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S = len(frames)
    eng = StreamEngine(cfg, sys_.im, n_slots=S, **engine_kw)
    eng.set_plan(plan)
    eng.warmup()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    for t, w in enumerate(words):
        submit_step(eng, frames, t, w)
    res = {f"cam{s}": [] for s in range(S)}
    states = []

    def one(_t):
        for sid, r in eng.step().items():
            res[sid].append(r)
        eng.sync()
        states.append(eng.state)

    build.reset_launches()
    step_ms, busy = _timed_steps(len(words), one, profile)
    return (res, states, dict(build.LAUNCHES), step_ms, busy,
            len(eng.graphs) if eng.graphs else 0)


def _switch_stream(cfg, sys_, frames, words, plan, profile, jit=True):
    """Stream 0 of ``words`` through ``torr_window_step(fused="switch",
    plan=plan)`` on the card, with the queue depth the engine gives it
    (its backlog after the pop), through a graph family of its own (as
    ``run_torr`` runs it; an all-pad window captures its first key before
    the timed windows, as an engine's warm-up does) or, without ``jit``,
    eagerly; launches counted from zero. Returns the final state, the results, the launches, the
    step ms, the device busy ms and the graph count."""
    from repro_torch.core import capture, pipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    im = sys_.im.to(resolve_device())
    graphs = capture.GraphFamily() if jit else None
    T, n = len(words), cfg.N_max
    st = pipeline.init_state(cfg, sys_.task_w[0])
    res = []
    if jit:   # an all-pad window at the first depth captures, untimed
        fr = frames[0][0]
        pipeline.torr_window_step(
            st, im, torch.zeros_like(words[0][:n]), np.zeros_like(fr.valid),
            fr.boxes, T - 1, cfg, plan=plan, fused="switch", graphs=graphs)

    def one(t):
        nonlocal st
        fr = frames[0][t]
        st, out, tel = pipeline.torr_window_step(
            st, im, words[t][:n], fr.valid, fr.boxes, T - 1 - t, cfg,
            plan=plan, fused="switch", graphs=graphs)
        res.append((out, tel))
        torch.cuda.synchronize()

    build.reset_launches()
    step_ms, busy = _timed_steps(T, one, profile)
    return (st, res, dict(build.LAUNCHES), step_ms, busy,
            len(graphs) if graphs else 0)


def _check_plan_windows(label, res, plan, encoding):
    """Every window ran the plan's planes within its bank cap, with
    finite scores, and records the lowering ``encoding``."""
    for sid, wins in res.items():
        for t, (out, tel) in enumerate(wins):
            got = tuple(int(getattr(tel, f)) for f in LOWERING_FIELDS)
            if int(tel.planes) != plan.planes or \
                    int(tel.banks) > plan.banks or got != encoding or \
                    not bool(torch.isfinite(out.scores).all()):
                raise AssertionError(
                    f"{label} {sid} window {t}: planes {int(tel.planes)}, "
                    f"banks {int(tel.banks)}, lowering {got}")


# the plan ladder's engines: name, engine knobs, the kernels each must
# launch, and its (fused_mode, decide_mode) telemetry encoding
PLAN_LOWERINGS = (
    ("prefix", {}, ("bank_prefix_hamming",), (FUSED_PREFIX, DECIDE_NONE)),
    ("compact", dict(fused="compact"),
     ("packed_hamming_batched", "bank_prefix_hamming"),
     (FUSED_COMPACT, DECIDE_BATCHED)))


def phase_plans(cfg, sys_, served, reuse, runs):
    """Every level of the edge ladder on the prefix, compact and switch
    lowerings, both traffics, each step timed (see the module docstring,
    phase 8); every run is recorded for :func:`phase_eager`. Returns one
    row per (traffic, level, lowering)."""
    from repro_torch.control import build_ladder
    from repro_torch.core.types import map_tensors
    from repro_torch.perf.profile_step import encode_step

    ladder = build_ladder(cfg)
    R = torch.as_tensor(sys_.R).cuda()
    S = len(served)
    rows = []
    T = PLAN_WINDOWS
    n_graphs = []
    for traffic, frames in (("served", served), ("reuse", reuse)):
        frames = [fr[:T] for fr in frames]
        words = [encode_step(frames, t, R) for t in range(T)]
        for level, plan in enumerate(ladder):
            tag = f"plan {level} ({plan.banks},{plan.planes}) {traffic}"
            runs_l = {}
            for low, kw, kernels, enc in PLAN_LOWERINGS:
                tier = S * cfg.N_max if low == "compact" else 0
                res, states, launches, ms, _busy, graphs = _serve_words(
                    cfg, sys_, frames, words, plan, False, **kw)
                _require_launched(f"{tag} {low}", launches, kernels)
                _check_plan_windows(f"{tag} {low}", res, plan, enc + (tier,))
                runs_l[low] = (res, states, ms, S, graphs, kw)
                n_graphs.append(graphs)
            base_res, base_states = runs_l["prefix"][:2]
            res, states = runs_l["compact"][:2]
            _assert_results_equal(f"{tag} compact", res, base_res,
                                  skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} compact", states[-1].cache,
                                 base_states[-1].cache)
            st, res_sw, launches, ms, _busy, graphs = _switch_stream(
                cfg, sys_, frames, words, plan, False)
            n_graphs.append(graphs)
            _require_launched(f"{tag} switch", launches,
                              ("fused_scores", "delta_update"))
            _check_plan_windows(f"{tag} switch", {"cam0": res_sw}, plan,
                                (FUSED_SWITCH, DECIDE_NONE, 0))
            _assert_results_equal(f"{tag} switch", {"cam0": res_sw},
                                  base_res, skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} switch", st.cache, map_tensors(
                lambda x: x[0], base_states[-1].cache))
            runs_l["switch"] = ({"cam0": res_sw}, [st], ms, 1, graphs, None)
            for low, (res, states, ms, wins, graphs, kw) in runs_l.items():
                row = dict(traffic=traffic, level=level, banks=plan.banks,
                           planes=plan.planes, lowering=low, ms_per_step=ms,
                           eager_ms_per_step=None,
                           windows_per_s=1e3 * wins / statistics.median(ms),
                           device_busy_ms=None, idle_share=None)
                rows.append(row)
                log(f"[{tag} {low}] {wins} windows/step: ms/step "
                    f"{[round(x, 2) for x in ms]} = "
                    f"{row['windows_per_s']:.1f} windows/s; graphs {graphs}")
                _captured_run(runs, f"{tag} {low}", res, states[-1].cache,
                              ms, graphs,
                              _eager_plan(cfg, sys_, frames, words, plan, kw),
                              row=row)
            log(f"[{tag}] compact and switch == card prefix engine in every "
                f"field; path mix after the first window "
                f"{_path_mix(frames, base_res)}")
            if traffic == "reuse" and \
                    (plan.banks, plan.planes) in PLAN_CPU_LEVELS:
                _equal_to_cpu(tag, base_res, base_states, T, _cpu_engine(
                    cfg, sys_, frames, words, T, plan=plan))
    log(f"[plan ladder graphs] {sum(n_graphs)} graphs captured over "
        f"{len(n_graphs)} engines and switch streams (at most "
        f"{max(n_graphs)} each); torch.cuda.memory_reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")
    return rows


def _eager_plan(cfg, sys_, frames, words, plan, kw):
    """The eager twin of a ladder run: the engine (``kw``) with
    ``jit=False``, or the switch stream without a graph family (``kw`` is
    None); returns (results, final cache, step ms)."""
    def run():
        if kw is None:
            st, res, _l, ms, _b, _g = _switch_stream(cfg, sys_, frames, words,
                                                     plan, False, jit=False)
            return {"cam0": res}, st.cache, ms
        res, states, _l, ms, _b, _g = _serve_words(cfg, sys_, frames, words,
                                                   plan, False, jit=False,
                                                   **kw)
        return res, states[-1].cache, ms
    return run


def phase_eager(runs):
    """Every captured run of phases 3-5 and 8 again on the eager step
    (``StreamEngine(jit=False)``, the switch stream without graphs): every
    output, telemetry field and final cache must be bit-equal to the
    captured run's. Prints each run's eager and captured ms/step and one
    line with each lowering's, the graph counts and the memory the
    caching allocator holds."""
    for r in runs:
        res, cache, ms = r["eager"]()
        for sid, wins in r["res"].items():
            if len(res[sid]) != len(wins):
                raise AssertionError(f"{r['label']} eager: {sid} "
                                     f"{len(res[sid])} windows")
        _assert_results_equal(f"{r['label']} eager", res, r["res"])
        _assert_caches_equal(f"{r['label']} eager", cache, r["cache"])
        r["eager_ms"] = statistics.median(ms)
        if r["row"] is not None:
            r["row"]["eager_ms_per_step"] = ms
        log(f"[eager == captured] {r['label']}: outputs, telemetry and final "
            f"caches bit-equal; ms/step eager {r['eager_ms']:.2f}, captured "
            f"{r['ms']:.2f} ({r['graphs']} graphs)")
    log("[eager vs captured] median ms/step, eager / captured: " + "; ".join(
        f"{r['label']} {r['eager_ms']:.2f} / {r['ms']:.2f} ({r['graphs']} "
        f"graphs)" for r in runs if r["row"] is None)
        + f"; torch.cuda.memory_reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")


def phase_plan_idle(cfg, sys_, served, rows):
    """The device-idle share of every (level, lowering) on the served
    traffic: the same two windows again on a fresh engine, the second
    under torch.profiler, its device busy time against the second
    window's host time in :func:`phase_plans`. It runs after every timed
    phase, since a profiled step slows the untraced steps after it."""
    from repro_torch.control import build_ladder
    from repro_torch.perf.profile_step import encode_step

    R = torch.as_tensor(sys_.R).cuda()
    frames = [fr[:PLAN_WINDOWS] for fr in served]
    words = [encode_step(frames, t, R) for t in range(PLAN_WINDOWS)]
    row_of = {(r["level"], r["lowering"]): r for r in rows
              if r["traffic"] == "served"}
    for level, plan in enumerate(build_ladder(cfg)):
        busy = {low: _serve_words(cfg, sys_, frames, words, plan, True,
                                  **kw)[4]
                for low, kw, _k, _e in PLAN_LOWERINGS}
        busy["switch"] = _switch_stream(cfg, sys_, frames, words, plan,
                                        True)[4]
        for low, b in busy.items():
            row = row_of[(level, low)]
            row["device_busy_ms"] = b
            row["idle_share"] = 1.0 - b / row["ms_per_step"][-1]
        log(f"[plan {level} ({plan.banks},{plan.planes}) served idle] "
            + "; ".join(f"{low}: device busy {b:.2f} ms of "
                        f"{row_of[(level, low)]['ms_per_step'][-1]:.2f} ms, "
                        f"idle {row_of[(level, low)]['idle_share']:.4f}"
                        for low, b in busy.items()))


class FrameClock:
    """The deadline tracker's clock: the host's monotonic clock, except on
    a thread that pinned it to a frame's time, where it returns that time:
    the arrival stamp of every window the thread submits meanwhile."""

    def __init__(self):
        self._pinned = threading.local()

    def pin(self, t) -> None:
        self._pinned.t = t

    def __call__(self) -> float:
        t = getattr(self._pinned, "t", None)
        return time.monotonic() if t is None else t


def _submit_futures(eng, frames, words, T):
    """Submit window t < T of every stream ``cam<s>`` (its N_max rows of
    step t's words) to an async engine. Returns each stream's futures."""
    n = eng.cfg.N_max
    futs = {f"cam{s}": [] for s in range(len(frames))}
    for t in range(T):
        for s, fr in enumerate(frames):
            futs[f"cam{s}"].append(eng.submit(
                f"cam{s}", words[t][s * n:(s + 1) * n], fr[t].valid,
                fr[t].boxes))
    return futs


def _admit_all(eng, sys_, S):
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])


def _captures_after(graphs, n0):
    """The captures a graph family made after its first ``n0``, as
    (segment, seconds)."""
    return [(name, round(sec, 3)) for name, sec in graphs.captures[n0:]]


def phase_governed(cfg, sys_, frames):
    """The compact lowering under the QoS governor at RT-60 through
    ``AsyncStreamEngine`` (phase 9), fed live, twice: see
    :func:`_governed_run`. First under the RT-60 admission policy as
    served, shedding on: which windows it sheds depends on the host's
    timing (a window that waits for the engine lock past budget + margin
    is shed, and one slow step lifts the step EMA past that for every
    later window, since shed windows measure no step), so that run is
    replayed bit-equal and reported, and no plan is required of it. Then
    with shedding off (``allow_shed=False``: a late window is escalated,
    never dropped): every window is served, and the governor must latch a
    reduced plan for a served step, since a compact step of 16 streams
    (16 ms on the card before its host work) exceeds level 0's usable
    slack (the budget less the governor's 25 % margin, 12.5 ms)."""
    from repro_torch.perf.profile_step import encode_step

    R = torch.as_tensor(sys_.R).cuda()
    words = [encode_step(frames, t, R) for t in range(len(frames[0]))]
    _governed_run(cfg, sys_, frames, words, allow_shed=True)
    levels = _governed_run(cfg, sys_, frames, words, allow_shed=False)
    if not any(levels):
        raise AssertionError("governed, shedding off: the governor latched "
                             "no reduced plan for a served step")


def _governed_run(cfg, sys_, frames, words, allow_shed):
    """One governed run: a ``DeadlineTracker`` (RT-60, shedding as
    ``allow_shed`` says), a ``Governor``, the reuse windows fed live to
    the running engine, window t of every stream
    submitted at frame time t (frames one RT-60 budget apart) and stamped
    with it; the dispatcher gates each head window and latches the
    governor's plan each step, the collector feeds the measured step back
    to the tracker and each window's modeled energy to the governor. Each
    dispatched step's windows and queue-depth lanes are recorded. Then the
    run replayed on a fresh sync prefix engine: before each step the
    windows it served are submitted, behind the windows of their streams
    shed before them (the replay's gate sheds those again), the step's
    recorded queue depths replace the replay's, and the governor's log
    gives its plan; every served window and the final caches bit-equal.
    With shedding off every window must be served. Returns the plan level
    of each served step."""
    from repro_torch.configs.torr_edge import rt_budget_s
    from repro_torch.control import Governor, build_ladder, policy_for
    from repro_torch.kernels import build
    from repro_torch.obs import FlightRecorder, Tracer
    from repro_torch.serving import deadline
    from repro_torch.serving.async_engine import AsyncStreamEngine
    from repro_torch.serving.stream_engine import (GATE_ADMIT, GATE_SHED,
                                                   StreamEngine)

    S, T, n = len(frames), len(frames[0]), cfg.N_max
    budget = rt_budget_s(GOVERNED_RT)
    clock = FrameClock()
    tracker = deadline.DeadlineTracker(
        deadline.policy_for(GOVERNED_RT, allow_shed=allow_shed), clock=clock)
    label = "shedding on" if allow_shed else "shedding off"
    gov = Governor(cfg, policy_for(GOVERNED_RT))
    tracer, flight = Tracer(), FlightRecorder()
    batches = []     # each dispatched step's (window seqs, queue depths)

    class Recorded(AsyncStreamEngine):
        def _dispatch(self, q, v, b, qd):
            batches.append(([c.seq for c in self._step_ctxs],
                            qd.numpy().copy()))
            return super()._dispatch(q, v, b, qd)

    def window(s, t):
        return (f"cam{s}", words[t][s * n:(s + 1) * n], frames[s][t].valid,
                frames[s][t].boxes)

    eng = Recorded(cfg, sys_.im, n_slots=S, fused="compact", tracker=tracker,
                   governor=gov, paused=True, tracer=tracer, flight=flight)
    try:
        t_warm = time.perf_counter()
        eng.warmup()     # every ladder level's first key
        warm_s = time.perf_counter() - t_warm
        n_warm = len(eng.graphs.captures)
        _admit_all(eng, sys_, S)
        futs = {f"cam{s}": [] for s in range(S)}
        build.reset_launches()
        eng.start()
        t0 = time.monotonic()
        for t in range(T):   # the camera: frame t leaves at t0 + t * budget
            at = t0 + t * budget
            time.sleep(max(0.0, at - time.monotonic()))
            clock.pin(at)
            for s in range(S):
                futs[f"cam{s}"].append(eng.submit(*window(s, t)))
            clock.pin(None)
        eng.flush(timeout=600)
        wall = time.monotonic() - t0
        launches = dict(build.LAUNCHES)
        res, shed = {sid: [] for sid in futs}, 0
        for sid, fs in futs.items():
            for f in fs:
                try:
                    res[sid].append(f.result(timeout=60))
                except deadline.WindowShed:
                    shed += 1
        cache = eng.state.cache
    finally:
        eng.close()
    summ = tracker.summary()
    steps = eng.stats.steps
    levels = [level for _b, _p, level in gov.plan_log]
    # the engine lock is held through both dispatcher spans of a step: the
    # assembly and gate (host_decide), then the copies in, the decide
    # graph, the host read of the full-path count and the finish graph
    # (dispatch_enqueue); every window of a step carries the same spans
    held = {phase: statistics.median(
        e["dur_us"] / 1e3 for ctx in tracer.completed() for e in ctx.events
        if e["phase"] == phase) if steps else float("nan")
        for phase in ("host_decide", "dispatch_enqueue")}
    step_ms = [round(1e3 * r["step_latency_s"], 2) for r in flight.records()]
    log(f"[governed, {label}] AsyncStreamEngine, compact, {GOVERNED_RT} "
        f"({1e3 * budget:.2f} ms), {S} streams x {T} windows fed live at "
        f"frame times: {eng.stats.windows} served, {shed} shed in {steps} "
        f"steps (windows a step {[len(w) for w, _ in batches]}, step "
        f"latency ms {step_ms}), wall "
        f"{wall:.3f} s; deadline p99 {summ['p99_ms']:.2f} ms, miss_rate "
        f"{summ['miss_rate']:.3f}, shed {summ['shed']}, escalated "
        f"{summ['escalated']}, step EMA {summ['step_ema_ms']:.2f} ms; "
        f"engine lock held a step (median ms): host_decide "
        f"{held['host_decide']:.3f}, dispatch_enqueue "
        f"{held['dispatch_enqueue']:.3f}; "
        f"plan_log {gov.plan_log}; governor {gov.summary()}; warm-up "
        f"{warm_s:.3f} s ({n_warm} captures, every ladder level); captures "
        f"after warm-up {_captures_after(eng.graphs, n_warm)}; launches "
        f"{launches}")
    if eng.stats.windows + shed != S * T:
        raise AssertionError("governed: windows neither served nor shed")
    if not allow_shed and shed:
        raise AssertionError(f"governed, {label}: {shed} windows shed")
    if len(batches) != steps or len(levels) != steps:
        raise AssertionError(f"governed: {steps} steps, {len(batches)} "
                             f"recorded, {len(levels)} plans logged")
    _require_launched("governed", launches,
                      ("packed_hamming_batched", "bank_prefix_hamming"))

    # window seq k is stream k % S's window k // S (one submitting thread)
    ctxs = sorted(tracer.completed(), key=lambda c: c.seq)
    if [c.stream_id for c in ctxs] != [f"cam{k % S}" for k in range(S * T)]:
        raise AssertionError("governed: traced windows out of order")
    shed_seqs = {c.seq for c in ctxs if c.decision == "shed"}

    class Replay(StreamEngine):
        qd_next = None

        def _assemble(self, gate=None):
            # a slot's queue holds its shed windows, then the served one
            q, v, b, qd, served = super()._assemble(
                lambda _sid, backlog, _extra:
                    GATE_SHED if backlog else GATE_ADMIT)
            qd.copy_(torch.from_numpy(self.qd_next))
            return q, v, b, qd, served

    replay = Replay(cfg, sys_.im, n_slots=S)
    _admit_all(replay, sys_, S)
    ladder = build_ladder(cfg)
    fed, got = [0] * S, {sid: [] for sid in res}
    for (seqs, qd), level in zip(batches, levels):
        for seq in seqs:
            s, t = seq % S, seq // S
            if any(u * S + s not in shed_seqs for u in range(fed[s], t)):
                raise AssertionError(f"governed: cam{s} window {t} served "
                                     f"past an unshed window")
            for u in range(fed[s], t + 1):
                replay.submit(*window(s, u))
            fed[s] = t + 1
        replay.qd_next = qd
        replay.set_plan(ladder[level])
        out = replay.step()
        if sorted(out) != sorted(f"cam{seq % S}" for seq in seqs):
            raise AssertionError("governed replay: another batch assembled")
        for sid, r in out.items():
            got[sid].append(r)
    replay.sync()
    for sid in res:
        if len(got[sid]) != len(res[sid]):
            raise AssertionError(f"governed replay {sid}: {len(got[sid])} "
                                 f"windows, {len(res[sid])} served")
    _assert_results_equal("governed replay", res, got, skip=LOWERING_FIELDS)
    _assert_caches_equal("governed replay", cache, replay.state.cache)
    log(f"[governed, {label}] replayed on a fresh sync prefix engine, "
        f"each step's windows, queue depths and plan (levels {levels}) as "
        f"served: every "
        f"served window and the final caches bit-equal")
    return levels


def _drain_timed(run, profile):
    """``run`` on the host clock; with ``profile`` under torch.profiler,
    its wall time still taken around ``run`` alone inside the profiled
    region (the profiler's start and the processing of its trace left
    out), beside the device busy ms of that same run. Returns (seconds,
    busy ms or None)."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        run()
        wall.append(time.perf_counter() - t0)

    busy = _device_busy_ms(timed) if profile else timed()
    return wall[0], busy


def _sync_pass(eng, sys_, frames, words, T, profile=False):
    """Every window queued first, then ``step`` until drained and one
    sync, on the host clock (or, with ``profile``, under torch.profiler:
    the device busy ms); the streams retired after. Returns the results,
    the final cache, the seconds and the device busy ms (None)."""
    from repro_torch.perf.profile_step import submit_step

    S = len(frames)
    _admit_all(eng, sys_, S)
    for t in range(T):
        submit_step(eng, frames, t, words[t])
    res = {f"cam{s}": [] for s in range(S)}

    def run():
        while eng.busy:
            for sid, r in eng.step().items():
                res[sid].append(r)
        eng.sync()

    wall, busy = _drain_timed(run, profile)
    cache = eng.state.cache
    for s in range(S):
        eng.retire(f"cam{s}")
    return res, cache, wall, busy


def _async_pass(cfg, sys_, frames, words, T, profile=False, **kw):
    """A paused ``AsyncStreamEngine`` (warmed up, its workers started after
    every window is queued) over the same windows: from ``start`` to the
    end of ``flush`` on the host clock (or under torch.profiler). Returns
    the host results, the final cache, the seconds, the device busy ms,
    the launches, the engine and its captures after the warm-up."""
    from repro_torch.kernels import build
    from repro_torch.serving.async_engine import AsyncStreamEngine

    S = len(frames)
    eng = AsyncStreamEngine(cfg, sys_.im, n_slots=S, paused=True, **kw)
    try:
        eng.warmup()
        n_warm = len(eng.graphs.captures)
        _admit_all(eng, sys_, S)
        futs = _submit_futures(eng, frames, words, T)
        build.reset_launches()

        def run():
            eng.start()
            eng.flush(timeout=600)
            torch.cuda.synchronize()

        wall, busy = _drain_timed(run, profile)
        launches = dict(build.LAUNCHES)
        res = {sid: [f.result(timeout=60) for f in fs]
               for sid, fs in futs.items()}
        cache = eng.state.cache
    finally:
        eng.close()
    return (res, cache, wall, busy, launches, eng,
            _captures_after(eng.graphs, n_warm))


def phase_async(cfg, sys_, cases, runs):
    """Async == sync (phase 9a): ``AsyncStreamEngine(paused=True,
    tracker=None)`` on the prefix and compact lowerings over both traffics'
    packed words of phases 3 and 4, and the serial switch engine over the
    served traffic's first window a stream (its profiled step alone takes
    some 15 s): every output, telemetry field and final cache bit-equal to
    that lowering's captured sync run of phases 3-5 (serial switch: to a
    captured sync engine's drain of the same windows). Each
    engine's ms/step and windows/s (every window queued first: the drain
    to its sync, the workers' start to the end of ``flush``), then the
    same run again under torch.profiler: its device busy ms and, against
    its own wall time, the idle share (1 - busy / wall); one summary
    line."""
    from repro_torch.kernels import build
    from repro_torch.serving.stream_engine import StreamEngine

    by_label = {r["label"]: r for r in runs}
    rows = []
    for label, frames, words, T, ref_label, kernels, kw in cases:
        t_case = time.perf_counter()
        S = len(frames)
        sync = StreamEngine(cfg, sys_.im, n_slots=S, **kw)
        sync.warmup()
        build.reset_launches()
        res_s, cache_s, wall_s, _ = _sync_pass(sync, sys_, frames, words, T)
        _require_launched(f"{label} sync", dict(build.LAUNCHES), kernels)
        _, _, pwall_s, busy_s = _sync_pass(sync, sys_, frames, words, T,
                                           profile=True)
        res_a, cache_a, wall_a, _, launches, eng, captured = _async_pass(
            cfg, sys_, frames, words, T, **kw)
        _require_launched(f"{label} async", launches, kernels)
        # the lowering's captured sync run of phases 3-5 where there is
        # one (the same windows queued the same way), else this drain
        what, other, other_cache = (
            ("the sync drain", res_s, cache_s) if ref_label is None else
            (f"the captured sync run '{ref_label}'",
             by_label[ref_label]["res"], by_label[ref_label]["cache"]))
        _assert_results_equal(f"{label} async vs {what}", res_a, other)
        _assert_caches_equal(f"{label} async vs {what}", cache_a,
                             other_cache)
        _, _, pwall_a, busy_a, *_ = _async_pass(cfg, sys_, frames, words, T,
                                                profile=True, **kw)
        steps = eng.stats.steps
        row = dict(label=label, steps=steps, windows=eng.stats.windows,
                   sync_ms_per_step=1e3 * wall_s / steps,
                   async_ms_per_step=1e3 * wall_a / steps,
                   sync_windows_per_s=eng.stats.windows / wall_s,
                   async_windows_per_s=eng.stats.windows / wall_a,
                   sync_busy_ms=busy_s, async_busy_ms=busy_a,
                   sync_profiled_ms=1e3 * pwall_s,
                   async_profiled_ms=1e3 * pwall_a,
                   sync_idle=1.0 - busy_s / (1e3 * pwall_s),
                   async_idle=1.0 - busy_a / (1e3 * pwall_a),
                   captures_after_warmup=captured)
        rows.append(row)
        log(f"[async == sync] {label}: outputs, telemetry and final caches "
            f"bit-equal to {what}; "
            f"{steps} steps, ms/step sync {row['sync_ms_per_step']:.2f} / "
            f"async {row['async_ms_per_step']:.2f}, windows/s "
            f"{row['sync_windows_per_s']:.1f} / "
            f"{row['async_windows_per_s']:.1f}; profiled run: device busy "
            f"ms {busy_s:.2f} / {busy_a:.2f} of wall ms "
            f"{row['sync_profiled_ms']:.2f} / {row['async_profiled_ms']:.2f}"
            f", idle share "
            f"{row['sync_idle']:.4f} / {row['async_idle']:.4f}; captures "
            f"after the async warm-up {captured}; launches {launches}; "
            f"{time.perf_counter() - t_case:.1f} s")
    log("[async vs sync] ms/step sync / async: " + "; ".join(
        f"{r['label']} {r['sync_ms_per_step']:.2f} / "
        f"{r['async_ms_per_step']:.2f}" for r in rows))
    return rows


def phase_launcher():
    """The port's launcher once (phase 9b): ``run_torr_streams(16, 4,
    rt="RT-60", governor=True)`` with the three artifacts into a temporary
    directory; every submitted window served or shed, at least one served,
    all three artifacts parse, and the launches counted after the engine's
    warm-up (which captures and replays every ladder level) show the
    encode once a stream and ``bank_prefix_hamming`` once a served step."""
    import tempfile

    from repro_torch.launch.serve import run_torr_streams
    from repro_torch.obs import load_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: str(Path(tmp) / name) for k, name in (
            ("metrics_json", "metrics.json"), ("flight_jsonl", "flight.jsonl"),
            ("trace_json", "trace.json"))}
        t0 = time.perf_counter()
        res = run_torr_streams(STREAMS, WINDOWS, rt=GOVERNED_RT,
                               governor=True, **paths)
        wall = time.perf_counter() - t0
        launches = res["launches"]
        snap = json.loads(Path(paths["metrics_json"]).read_text())
        recs = load_jsonl(paths["flight_jsonl"])
        doc = json.loads(Path(paths["trace_json"]).read_text())
    if res["lost"] or res["served"] + res["shed"] != res["submitted"] \
            or res["submitted"] != STREAMS * WINDOWS or not res["served"]:
        raise AssertionError(f"launcher: {res['submitted']} submitted, "
                             f"{res['served']} served, {res['shed']} shed")
    # the prefix lowering's graph holds one bank_prefix_hamming node
    if launches["sign_project_pack"] < STREAMS or res["steps"] < 1 or \
            launches["bank_prefix_hamming"] < res["steps"]:
        raise AssertionError(f"launcher: {res['steps']} steps served, "
                             f"launches after the warm-up {launches}")
    steps = [r for r in recs if "n_windows" in r]
    if sum(r["n_windows"] for r in steps) != res["served"] or \
            not doc["traceEvents"] or \
            snap["metrics"]["torr_windows_total"]["series"][0]["value"] \
            != res["served"]:
        raise AssertionError("launcher: artifacts disagree with the run")
    log(f"[launcher] run_torr_streams({STREAMS}, {WINDOWS}, rt="
        f"{GOVERNED_RT}, governor=True) on the card: {res['submitted']} "
        f"submitted, {res['served']} served, {res['shed']} shed, 0 lost; "
        f"{len(steps)} flight records, {len(doc['traceEvents'])} trace "
        f"events, {len(snap['metrics'])} metric families; {wall:.2f} s "
        f"with the build of its system; {res['steps']} steps; launches "
        f"after the warm-up {launches}")


# -- phases 12 and 13: supervised recovery and the gateway -------------------

SUP_FAULTS = (("dispatcher", 3), ("collector", 5))
# (c): a collector death at step 6 at cadence 4: steps 0-5 were delivered,
# the store covers 0-3, so windows 4 and 5 re-run silently
JSONL_FAULT_AT = 6
CRASH_LOOP = 3              # (e): engines that die at step 0, and the
#                             breaker's threshold
LAUNCHER_RESUME = (2, 10)   # (f): streams, frames
GATEWAY_TENANTS = 4         # phase 13: stream s belongs to tenant s mod 4


def _session(s) -> str:
    """Phase 13's session id of stream s: ``t<s mod tenants>/cam<s>``."""
    return f"t{s % GATEWAY_TENANTS}/cam{s}"


def _memory(dev):
    """(allocated, reserved) bytes on the card (zeros on the CPU)."""
    if torch.device(dev).type != "cuda":
        return 0, 0
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


class _Factory:
    """The supervised runs' engines. Each is warmed up (its current key
    captured) before the supervisor admits into it, and the launch
    counts are set to 0 after that warm-up, so the counts after a run are
    those of the last engine's served steps. ``faults`` gives the n-th
    engine built its FaultPlan (None after the tuple). Records the memory
    before each build and each warm-up's seconds and captures; it keeps no
    engine (a dead engine's graph family must be freed)."""

    def __init__(self, cfg, sys_, S, store, cadence, faults=(), sync=False,
                 dev="cuda", **kw):
        self.cfg, self.sys_, self.S = cfg, sys_, S
        self.store, self.cadence, self.faults = store, cadence, faults
        self.sync, self.dev, self.kw = sync, dev, kw
        self.built = 0
        self.memory = []        # (allocated, reserved) before each build
        self.warm = []          # (seconds, captures) of each warm-up
        self.after_first = None  # memory after the first engine's warm-up

    def __call__(self):
        from repro_torch.kernels import build
        from repro_torch.serving.async_engine import AsyncStreamEngine
        from repro_torch.serving.stream_engine import StreamEngine

        self.memory.append(_memory(self.dev))
        fault = self.faults[self.built] if self.built < len(self.faults) \
            else None
        self.built += 1
        kw = dict(self.kw, store=self.store, snapshot_every=self.cadence,
                  fault_plan=fault, device=self.dev)
        eng = (StreamEngine(self.cfg, self.sys_.im, n_slots=self.S, **kw)
               if self.sync else
               AsyncStreamEngine(self.cfg, self.sys_.im, n_slots=self.S,
                                 paused=True, **kw))
        t0 = time.perf_counter()
        eng.warmup()
        self.warm.append((round(time.perf_counter() - t0, 3),
                          len(eng.graphs.captures) if eng.graphs else 0))
        if self.after_first is None:
            self.after_first = _memory(self.dev)
        build.reset_launches()
        return eng


def _sup_submit(front, sys_, frames, words, T, n, admit=True):
    """Admit stream ``cam<s>`` (task s mod tasks) and submit its windows
    0..T-1 (N_max rows of step t's words each), in the order phase 4 queued
    them; each stream's futures."""
    S = len(frames)
    if admit:
        _admit_all(front, sys_, S)
    futs = {f"cam{s}": [] for s in range(S)}
    for t in range(T):
        for s, fr in enumerate(frames):
            futs[f"cam{s}"].append(front.submit(
                f"cam{s}", words[t][s * n:(s + 1) * n], fr[t].valid,
                fr[t].boxes))
    return futs


def _supervised(cfg, sys_, frames, words, factory, **sup_kw):
    """One supervised run over every window: submitted through the
    supervisor, the async engine started (its wall from there to the end
    of ``flush``), every future's result. Returns (results, seconds,
    supervisor, launches after the last engine's warm-up)."""
    from repro_torch.kernels import build
    from repro_torch.serving.supervisor import ServeSupervisor

    T, n = len(frames[0]), cfg.N_max
    sup = ServeSupervisor(factory, factory.store, **sup_kw)
    try:
        futs = _sup_submit(sup, sys_, frames, words, T, n)
        t0 = time.perf_counter()
        if not factory.sync:
            sup.engine.start()
        # every window resolved: its step's results are on the host (no
        # device-wide sync, which an abandoned engine's capture forbids)
        sup.flush(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        res = {sid: [f.result(timeout=60) for f in fs]
               for sid, fs in futs.items()}
    finally:
        sup.close(drain=False)
    if not sup.join_abandoned(timeout=60):
        raise AssertionError("an abandoned engine's worker did not end")
    return res, wall, sup, launches


def _recoveries(sup) -> str:
    return "; ".join(
        f"recovery {i + 1}: {r.get('first_window_s', float('nan')):.3f} s "
        f"to the first window the rebuilt engine resolved "
        f"({r['rebuilt_s']:.3f} s to rebuilt, re-admitted and replay "
        f"submitted), "
        f"{len(r.get('captures', []))} captures "
        f"({sum(sec for _n, sec in r.get('captures', [])):.3f} s: "
        f"{[(n, round(sec, 3)) for n, sec in r.get('captures', [])]}), "
        f"{r['replayed']} windows replayed, {r['rerun']} re-run"
        for i, r in enumerate(sup.recoveries))


def _require_per_step(label, launches, steps, names):
    """At least one launch of each kernel a served step of the last
    engine (counted from 0 after its warm-up)."""
    for name in names:
        if steps < 1 or launches[name] < steps:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches for {steps} served steps")


def phase_supervised(cfg, sys_, frames, words, compact_ref, prefix_ref,
                     async_ms, dev="cuda"):
    """Supervised recovery (phase 12) over the reuse windows of phase 4
    (16 streams, 10 windows, the card's packed words). ``compact_ref``
    and ``prefix_ref`` are the captured sync compact run and phase 4's
    prefix run (phase 9a's async compact run equals the first);
    ``async_ms`` is phase 9a's async compact ms/step over the same windows
    without a store. Every rebuilt engine is warmed up by its factory; the
    launches after it must show a ``bank_prefix_hamming`` (and on compact
    two ``packed_hamming_batched``) each served step."""
    import gc
    import tempfile

    from repro_torch.control import build_ladder
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serving.state_store import (InMemoryStateStore,
                                                 JsonlStateStore)

    S, T = len(frames), len(frames[0])
    compact = ("packed_hamming_batched", "bank_prefix_hamming")
    rows = []

    def run(label, factory, ref, what, kernels, **sup_kw):
        t_case = time.perf_counter()
        res, wall, sup, launches = _supervised(cfg, sys_, frames, words,
                                               factory, **sup_kw)
        steps = sup.engine.stats.steps
        _require_per_step(label, launches, steps, kernels)
        if ref is not None:
            _assert_results_equal(label, res, ref)
        s = sup.summary()
        row = dict(label=label, restarts=s["restarts"],
                   replayed=s["windows_replayed"], rerun=s["windows_rerun"],
                   ms_per_step=1e3 * wall / max(1, steps), wall_s=wall,
                   recoveries=[{k: v for k, v in r.items() if k != "dead_at"}
                               for r in sup.recoveries],
                   warmups=factory.warm)
        rows.append(row)
        log(f"[supervised] {label}: {S} streams x {T} windows, "
            f"{what}; "
            f"restarts {s['restarts']}, windows replayed "
            f"{s['windows_replayed']}, re-run {s['windows_rerun']}; wall "
            f"{wall:.3f} s, any recovery included (the last engine "
            f"{steps} steps, {row['ms_per_step']:.2f} ms/step); engines "
            f"built "
            f"{factory.built}, warm-ups (s, captures) {factory.warm}; "
            f"{_recoveries(sup)}; launches after the last warm-up "
            f"{launches}; {time.perf_counter() - t_case:.1f} s")
        return res, sup, row

    compact_eq = ("every window bit-equal to the captured sync compact run "
                  "(== phase 9a's async compact run)")
    # (a) fault-free, snapshots at every window
    store = InMemoryStateStore()
    _, _, row_a = run("(a) compact, no fault, InMemoryStateStore, "
                      "snapshot_every=1",
                      _Factory(cfg, sys_, S, store, 1, fused="compact",
                               dev=dev), compact_ref, compact_eq, compact)
    if row_a["restarts"] or len(store.keys()) != S or \
            any(store.latest_seq(k) != T for k in store.keys()):
        raise AssertionError("(a): a restart, or the store does not cover "
                             "every window")
    log(f"[supervised] (a) ms/step {row_a['ms_per_step']:.2f} with the "
        f"store at every window against {async_ms:.2f} without one (phase "
        f"9a, the same windows)")
    # (b) one fault on either worker
    for kind, at in SUP_FAULTS:
        _, _, row = run(f"(b) compact, {kind} fault at step {at}",
                        _Factory(cfg, sys_, S, InMemoryStateStore(), 1,
                                 faults=(FaultPlan(at_step=at, thread=kind),),
                                 fused="compact", dev=dev),
                        compact_ref, compact_eq, compact, backoff_s=0.001)
        if row["restarts"] != 1 or row["replayed"] <= 0:
            raise AssertionError(f"(b) {kind}: {row['restarts']} restarts, "
                                 f"{row['replayed']} windows replayed")
    # (c) a JSONL store at cadence 4: the windows after its snapshot re-run
    with tempfile.TemporaryDirectory() as tmp:
        store = JsonlStateStore(Path(tmp) / "state.jsonl")
        try:
            _, _, row = run(
                f"(c) compact, JsonlStateStore, snapshot_every=4, tracker "
                f"off, collector fault at step {JSONL_FAULT_AT}",
                _Factory(cfg, sys_, S, store, 4,
                         faults=(FaultPlan(at_step=JSONL_FAULT_AT,
                                           thread="collector"),),
                         fused="compact", dev=dev),
                compact_ref, compact_eq, compact, backoff_s=0.001)
        finally:
            store.close()
        if row["restarts"] != 1 or row["rerun"] <= 0:
            raise AssertionError(f"(c): {row['restarts']} restarts, "
                                 f"{row['rerun']} windows re-run")
    # (d) the sync prefix engine under the supervisor
    _, _, row = run("(d) sync prefix, dispatcher fault at step 3",
                    _Factory(cfg, sys_, S, InMemoryStateStore(), 1,
                             faults=(FaultPlan(at_step=3),), sync=True,
                             dev=dev),
                    prefix_ref, "every window bit-equal to phase 4's prefix "
                    "run", ("bank_prefix_hamming",), backoff_s=0.001)
    if row["restarts"] != 1:
        raise AssertionError(f"(d): {row['restarts']} restarts")
    # (e) a crash loop until the breaker trips
    gc.collect()
    factory = _Factory(cfg, sys_, S, InMemoryStateStore(), 1,
                       faults=tuple(FaultPlan(at_step=0)
                                    for _ in range(CRASH_LOOP)),
                       fused="compact", dev=dev)
    res, sup, row = run(f"(e) compact, crash loop: engines 1-{CRASH_LOOP} "
                        f"die at step 0, breaker_restarts={CRASH_LOOP}",
                        factory, None, "every window resolved once (below)",
                        compact, breaker_restarts=CRASH_LOOP,
                        backoff_s=0.001)
    cheap = build_ladder(cfg)[-1]
    if row["restarts"] != CRASH_LOOP or not sup.degraded or \
            sup.engine.plan != cheap:
        raise AssertionError(f"(e): {row['restarts']} restarts, degraded "
                             f"{sup.degraded}, plan {sup.engine.plan}")
    n_res = sum(len(w) for w in res.values())
    if n_res != S * T or not all(
            np.isfinite(np.asarray(o.scores)).all()
            for w in res.values() for o, _ in w):
        raise AssertionError(f"(e): {n_res} windows resolved")
    del res, sup
    gc.collect()
    end = _memory(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    emptied = _memory(dev)
    base, first = factory.memory[0], factory.after_first
    mib = lambda b: round(b / 2**20, 1)  # noqa: E731
    log(f"[supervised] (e) memory (allocated, reserved) MiB: before the "
        f"first engine {tuple(map(mib, base))}, after its warm-up "
        f"{tuple(map(mib, first))}; after restart k (before engine k+1): "
        f"{[tuple(map(mib, m)) for m in factory.memory[1:]]}; after the "
        f"run, the engines dropped and the workers joined "
        f"{tuple(map(mib, end))}; after empty_cache "
        f"{tuple(map(mib, emptied))}; degrade plan {cheap} latched on the "
        f"surviving engine")
    # the dead engines' families freed: what stays allocated is below
    # three families' worth (four engines each captured its warm-up key)
    one = first[0] - base[0]
    if torch.device(dev).type == "cuda" and end[0] - base[0] > 3 * one:
        raise AssertionError(f"(e): {mib(end[0] - base[0])} MiB still "
                             f"allocated after the loop, one engine "
                             f"{mib(one)} MiB: dead families leaked")
    row["memory_mib"] = dict(
        before=tuple(map(mib, base)),
        after_first_warmup=tuple(map(mib, first)),
        after_restarts=[tuple(map(mib, m)) for m in factory.memory[1:]],
        after_run=tuple(map(mib, end)),
        after_empty_cache=tuple(map(mib, emptied)))
    rows.append(dict(label="(f) launcher", **_launcher_resume(dev)))
    return rows


def _read_ledger(path):
    recs = {}
    if not Path(path).exists():
        return recs
    for line in Path(path).read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue            # a torn trailing record of a killed run
        recs[(r["stream"], r["seq"])] = r
    return recs


def _launcher_resume(dev="cuda", attempts=2) -> dict:
    """(f): ``python -m repro_torch.launch.serve --torr-streams 2
    --torr-frames 10 --async --supervise --state-store ... --outputs-jsonl
    ...`` at the launcher's own config, SIGKILLed once its store holds a
    snapshot, then run again (it must skip the windows the store covers):
    the merged ledger must equal a fault-free run's, record for record. A
    kill that lands after the run ended is tried again once; every
    process is waited for."""
    import os
    import subprocess
    import tempfile

    S, T = LAUNCHER_RESUME
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--torr-streams", str(S), "--torr-frames", str(T), "--async",
            "--device", str(dev)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = Path(tmp) / "ref.jsonl"
        r = subprocess.run(base + ["--outputs-jsonl", str(ref)], env=env,
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"(f) fault-free launcher: "
                                 f"{r.stderr[-2000:]}")
        want = _read_ledger(ref)
        if len(want) != S * T:
            raise AssertionError(f"(f): {len(want)} fault-free records")
        for attempt in range(attempts):
            out = Path(tmp) / f"out{attempt}.jsonl"
            store = Path(tmp) / f"state{attempt}.jsonl"
            cmd = base + ["--supervise", "--state-store", str(store),
                          "--outputs-jsonl", str(out)]
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
            try:
                deadline = time.monotonic() + 300
                while p.poll() is None and time.monotonic() < deadline:
                    # a snapshot on disk: the run again has windows to skip
                    if store.exists() and b"\n" in store.read_bytes():
                        p.kill()
                        break
                    time.sleep(0.001)
                p.wait(timeout=60)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
            covered = _read_ledger(out)
            if p.returncode == 0:
                continue        # the run ended before the kill landed
            r2 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                timeout=300)
            if r2.returncode != 0 or "resumed" not in r2.stdout:
                raise AssertionError(f"(f) resumed launcher: rc "
                                     f"{r2.returncode} {r2.stdout[-2000:]} "
                                     f"{r2.stderr[-2000:]}")
            merged = _read_ledger(out)
            if merged != want or not set(covered) <= set(merged):
                raise AssertionError("(f): the merged ledger differs from "
                                     "the fault-free run's")
            skipped = [ln for ln in r2.stdout.splitlines() if "resumed" in ln]
            log(f"[supervised] (f) launcher {S} streams x {T} frames, "
                f"SIGKILLed with {len(covered)} of {S * T} records written "
                f"(attempt {attempt + 1}), run again ({skipped[0].strip()}): "
                f"merged ledger == the fault-free run's, record for record; "
                f"{time.perf_counter() - t0:.1f} s for the three runs")
            return dict(killed_at_records=len(covered), attempt=attempt + 1,
                        seconds=time.perf_counter() - t0)
    raise AssertionError(f"(f): the run ended before the kill in "
                         f"{attempts} attempts")


class _HeldFront:
    """The gateway's front with one submission held until released: it
    keeps a request in flight, so ``drain()`` waits for it and the
    requests made meanwhile can be observed. Everything else is the
    wrapped front's."""

    def __init__(self, front):
        self._front = front
        self.gate = False
        self.held = threading.Event()
        self.release = threading.Event()

    def __getattr__(self, name):
        return getattr(self._front, name)

    def submit(self, *args):
        if self.gate:
            self.gate = False
            self.held.set()
            self.release.wait(60)
        return self._front.submit(*args)


def _http(port, method, path, body=None, conn=None, timeout=120.0):
    """One request (on ``conn`` when given); (status, headers, body)."""
    import http.client

    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"}
                     if data else {})
        r = conn.getresponse()
        raw = r.read()
        hdr = {k.lower(): v for k, v in r.getheaders()}
        try:
            return r.status, hdr, json.loads(raw)
        except ValueError:
            return r.status, hdr, raw
    finally:
        if own:
            conn.close()


def _gateway_client(port, frames, words, n, n_tasks, log_req):
    """The client: 16 sessions ``t<s mod 4>/cam<s>`` (4 tenants of 4
    streams, within the default quota of 8 sessions a tenant; task s mod
    tasks), then window t of every stream, t = 0..T-1, posted one at a
    time in seq order with the packed words as uint32, each retried after
    its Retry-After on 429 and 503. Returns each window's response body
    and its seconds from the first attempt to the response served."""
    from repro_torch.serving import protocol

    S, T = len(frames), len(frames[0])
    for s in range(S):
        st, _, b = _http(port, "POST", "/v1/session",
                         {"tenant": _session(s).split("/")[0],
                          "stream": f"cam{s}",
                          "task": s % n_tasks})
        if st != 200:
            raise AssertionError(f"gateway: session cam{s}: {st} {b}")
    bodies, window_s = {}, {}
    for t in range(T):
        for s, fr in enumerate(frames):
            q = words[t][s * n:(s + 1) * n].cpu().numpy().view(np.uint32)
            frame = {"session": _session(s), "seq": t,
                     "q": protocol.encode_array(q),
                     "valid": protocol.encode_array(
                         np.asarray(fr[t].valid, bool)),
                     "boxes": protocol.encode_array(
                         np.asarray(fr[t].boxes, np.float32))}
            t_first = time.perf_counter()
            for _ in range(400):
                t0 = time.perf_counter()
                st, hdr, b = _http(port, "POST", "/v1/window", frame)
                log_req(st, time.perf_counter() - t0,
                        b.get("error") if isinstance(b, dict) else None)
                if st == 200:
                    bodies[(s, t)] = b
                    window_s[(s, t)] = time.perf_counter() - t_first
                    break
                if st not in (429, 503):
                    raise AssertionError(f"gateway: cam{s} window {t}: "
                                         f"{st} {b}")
                time.sleep(min(float(hdr.get("x-retry-after-s", 0.05)), 0.5))
            else:
                raise AssertionError(f"gateway: cam{s} window {t} never "
                                     "served")
    return bodies, window_s


def phase_gateway(cfg, sys_, frames, words, dev="cuda"):
    """The gateway (phase 13): an in-process ``Gateway`` on 127.0.0.1:0
    over a supervised ``AsyncStreamEngine`` (prefix) at the edge config; a
    client thread opens 16 sessions and posts the reuse windows in seq
    order, one request at a time. Every response's ``best`` and
    ``scores_sha256`` must equal a fresh sync prefix engine's on the card
    fed the same windows in the same order (one a step, as the gateway's
    engine serves them); then the same with a dispatcher fault at step 3,
    the client retrying after each 503's Retry-After; then ``drain()``
    with a request held in flight: ``/readyz`` not ready, a new window 503
    ``draining``."""
    from repro_torch.kernels import build
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.protocol import window_result_body
    from repro_torch.serving.state_store import InMemoryStateStore
    from repro_torch.serving.stream_engine import StreamEngine
    from repro_torch.serving.supervisor import ServeSupervisor

    S, T, n = len(frames), len(frames[0]), cfg.N_max
    n_tasks = sys_.task_w.shape[0]
    t_ref = time.perf_counter()
    ref = StreamEngine(cfg, sys_.im, n_slots=S, device=dev)
    ref.warmup()
    for s in range(S):
        ref.admit(_session(s), sys_.task_w[s % n_tasks])
    want = {}
    for t in range(T):
        for s, fr in enumerate(frames):
            ref.submit(_session(s), words[t][s * n:(s + 1) * n],
                       fr[t].valid, fr[t].boxes)
            out = ref.step()[_session(s)][0]
            want[(s, t)] = window_result_body(t, out)
    ref_s = time.perf_counter() - t_ref
    del ref
    log(f"[gateway] reference: a sync prefix engine on the card fed the "
        f"{S * T} windows one a step in the client's order: {ref_s:.1f} s")
    rows = []
    for label, fault in (("no fault", None),
                         ("dispatcher fault at step 3",
                          FaultPlan(at_step=3, thread="dispatcher"))):
        t_case = time.perf_counter()
        store = InMemoryStateStore()
        factory = _Factory(cfg, sys_, S, store, 1,
                           faults=(fault,) if fault else (), dev=dev)
        sup = ServeSupervisor(factory, store)
        front = _HeldFront(sup)
        gw = Gateway(front, cfg, sys_.task_w, port=0)
        reqs = []
        lock = threading.Lock()

        def log_req(st, sec, reason):
            with lock:
                reqs.append((st, sec, reason))

        result = {}

        def client():
            try:
                result["bodies"], result["window_s"] = _gateway_client(
                    gw.port, frames, words, n, n_tasks, log_req)
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                result["error"] = e

        drain_seen = None
        try:
            sup.engine.start()
            gw.start()
            th = threading.Thread(target=client, name="gateway-client")
            th.start()
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("gateway: the client did not finish")
            if "error" in result:
                raise result["error"]
            bodies = result["bodies"]
            launches = dict(build.LAUNCHES)
            steps = sup.engine.stats.steps
            if fault is not None:
                drain_seen = _drain_check(gw, front, frames, words, n, T)
        finally:
            gw.close()
            sup.close(drain=False)
        if not sup.join_abandoned(timeout=60):
            raise AssertionError("gateway: an abandoned engine's worker "
                                 "did not end")
        if set(bodies) != set(want):
            raise AssertionError("gateway: windows missing")
        for k, b in want.items():
            if bodies[k] != b:
                raise AssertionError(f"gateway {label}: cam{k[0]} window "
                                     f"{k[1]}: {bodies[k]} != {b}")
        _require_per_step(f"gateway {label}", launches, steps,
                          ("bank_prefix_hamming",))
        ok = sorted(sec for st, sec, _r in reqs if st == 200)
        win = sorted(result["window_s"].values())
        retries = {}
        for st, _sec, reason in reqs:
            if st != 200:
                retries[f"{st} {reason}"] = retries.get(f"{st} {reason}",
                                                        0) + 1
        s = sup.summary()
        row = dict(label=label, requests=len(reqs),
                   p50_ms=1e3 * ok[len(ok) // 2],
                   p99_ms=1e3 * ok[min(len(ok) - 1, int(0.99 * len(ok)))],
                   window_p50_ms=1e3 * win[len(win) // 2],
                   window_p99_ms=1e3 * win[min(len(win) - 1,
                                               int(0.99 * len(win)))],
                   window_max_ms=1e3 * win[-1], launches=launches,
                   retries=retries, restarts=s["restarts"],
                   replayed=s["windows_replayed"],
                   recoveries=[{k: v for k, v in r.items() if k != "dead_at"}
                               for r in sup.recoveries],
                   seconds=time.perf_counter() - t_case)
        rows.append(row)
        if s["restarts"] != (fault is not None):
            raise AssertionError(f"gateway {label}: {s['restarts']} "
                                 f"restarts")
        log(f"[gateway] {label}: {S} sessions x {T} windows over HTTP, "
            f"every response's best and scores_sha256 == the sync prefix "
            f"engine's; {len(reqs)} requests, latency of the served ones "
            f"p50 {row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms; a "
            f"window's, retries included, p50 {row['window_p50_ms']:.2f} "
            f"ms, p99 {row['window_p99_ms']:.2f} ms, max "
            f"{row['window_max_ms']:.2f} ms; retries {retries}; the last "
            f"engine's {steps} steps launched {launches} after its "
            f"warm-up; restarts {s['restarts']}, replayed "
            f"{s['windows_replayed']}; {_recoveries(sup)}; warm-ups (s, "
            f"captures) {factory.warm}; {row['seconds']:.1f} s")
        if drain_seen is not None:
            row["drain"] = drain_seen
            log(f"[gateway] drain with a window in flight: {drain_seen}")
    return rows


def _drain_check(gw, front, frames, words, n, T):
    """``drain()`` while a request is held in flight: on connections
    opened before it, ``/readyz`` must answer 503 not ready and a new
    window 503 ``draining``; the held window then resolves (200) and the
    drain reports True."""
    import http.client

    from repro_torch.serving import protocol

    conns = [http.client.HTTPConnection("127.0.0.1", gw.port, timeout=120)
             for _ in range(2)]
    for c in conns:        # accepted before the listener closes
        if _http(gw.port, "GET", "/healthz", conn=c)[0] != 200:
            raise AssertionError("drain: /healthz before the drain")

    def frame(s):
        q = words[T - 1][s * n:(s + 1) * n].cpu().numpy().view(np.uint32)
        fr = frames[s][T - 1]
        return {"session": _session(s), "seq": T,
                "q": protocol.encode_array(q),
                "valid": protocol.encode_array(np.asarray(fr.valid, bool)),
                "boxes": protocol.encode_array(
                    np.asarray(fr.boxes, np.float32))}

    held, drained = {}, {}
    front.gate = True
    th = threading.Thread(target=lambda: held.update(
        zip(("status", "headers", "body"),
            _http(gw.port, "POST", "/v1/window", frame(0)))))
    th.start()
    if not front.held.wait(60):
        raise AssertionError("drain: the held window never arrived")
    dr = threading.Thread(target=lambda: drained.update(
        ok=gw.drain(timeout=60)))
    dr.start()
    deadline = time.monotonic() + 30
    while not gw.summary()["draining"]:
        if time.monotonic() > deadline:
            raise AssertionError("drain: never began")
        time.sleep(0.001)
    try:
        st_r, _, b_r = _http(gw.port, "GET", "/readyz", conn=conns[0])
        st_w, _, b_w = _http(gw.port, "POST", "/v1/window", frame(1),
                             conn=conns[1])
    finally:
        front.release.set()
        th.join(timeout=120)
        dr.join(timeout=120)
        for c in conns:
            c.close()
    if st_r != 503 or b_r.get("ready") is not False or \
            b_r.get("draining") is not True:
        raise AssertionError(f"drain: /readyz {st_r} {b_r}")
    if st_w != 503 or b_w.get("error") != "draining":
        raise AssertionError(f"drain: new window {st_w} {b_w}")
    if held.get("status") != 200 or drained.get("ok") is not True:
        raise AssertionError(f"drain: held window {held.get('status')}, "
                             f"drained {drained.get('ok')}")
    return dict(readyz=[st_r, b_r], new_window=[st_w, b_w["error"]],
                held_window=held["status"], drained=drained["ok"])


# -- phase 14: the event front end, the encoder, the bridge, the reranker ----

FE_EVENTS = 512             # (a): events a padded batch holds
FE_DT = 0.004               # a window's width in seconds
# (a): (dt, T_bins) whose bin edges are held card to CPU (the phase's own
# and those of tests/test_torch_events.py's edge test)
FE_EDGE_CASES = ((FE_DT, 4), (0.003, 4), (1e-3, 7), (0.05, 3))
FE_PROPOSALS = 128          # (b): proposals encoded at once (torr_edge N_max)
FE_WINDOW = (4, 32, 32)     # (b): T_bins, H, W of a proposal's window
FE_TOL = 1e-5               # (b): z_e rtol and atol, per proposal
FE_EXCUSE = 1e-4            # (b): a potential this close to the threshold
FE_GRAD_TOL = 1e-4          # (b): ||g_card - g_cpu|| / ||g_cpu|| per tensor
# (b): a convolution wider than the encoder's (N, c_in, c_out, size), where
# cuDNN is likelier to take TF32 under the global flag
FE_WIDE_CONV = (128, 64, 64, 32)
# (d): qwen3-14b's widths (src/repro/configs/registry.py:68) under the
# launcher's reranker config (src/repro/launch/serve.py:908-913)
RR_D_MODEL, RR_VOCAB, RR_BATCH, RR_STEPS = 5120, 151936, 4, 32
RR_JUMPS = (10, 21)         # (d): decode steps whose hidden state jumps
RR_LOGIT_RTOL = 1e-5
RR_LOOPS = 5                # (d): timed runs of the 32 steps, the first counted


def _fe_events(seed, n, height, width):
    """A padded event batch, drawn with numpy: events past every edge (x, y
    outside the frame, t < 0 and t >= dt, polarity outside {0, 1}) and a
    count below the capacity, so padding must add nothing."""
    from repro_torch import convert

    rng = np.random.default_rng(seed)
    return convert.event_batch_from_numpy(
        x=rng.integers(-2, width + 2, n), y=rng.integers(-2, height + 2, n),
        t=rng.uniform(-0.1 * FE_DT, 1.1 * FE_DT, n),
        p=rng.integers(-1, 3, n), count=int(rng.integers(n // 2, n)))


def _fe_events_phase():
    """(a) ``aggregate_window`` and ``eq1_frame`` on the card, bit-equal to
    the port's CPU run, at T_bins 4 x 16 x 16 and 4 x 15 x 17."""
    from repro_torch.core import events

    for height, width in ((16, 16), (15, 17)):
        for seed in range(4):
            ev = _fe_events(100 * height + seed, FE_EVENTS, height, width)
            for name, fn in (
                    ("aggregate_window", lambda e: events.aggregate_window(
                        e, FE_DT, 4, height, width)),
                    ("eq1_frame", lambda e: events.eq1_frame(e, height,
                                                             width))):
                got, want = fn(ev.to("cuda")), fn(ev)
                if not bits_equal(got, want):
                    raise AssertionError(f"events: {name} at {height}x"
                                         f"{width}, seed {seed} != the CPU")
    log(f"[front end] (a) aggregate_window and eq1_frame at 4x16x16 and "
        f"4x15x17, {FE_EVENTS} events a batch with padding and "
        f"out-of-range entries, 4 batches each: bit-equal to the CPU")
    _fe_edges_phase()


def _fe_edge_times(dt, t_bins):
    """float32 times on and one ulp either side of every bin edge from -dt
    / t_bins to dt + dt / t_bins, and every whole microsecond from -dt / 4
    to 5 dt / 4 (a DVS sensor's timestamps)."""
    edges = np.arange(-1, t_bins + 2, dtype=np.float64) * dt / t_bins
    us = np.arange(round(-0.25 * dt * 1e6), round(1.25 * dt * 1e6) + 1)
    return np.concatenate([edges, np.nextafter(edges, -np.inf),
                           np.nextafter(edges, np.inf),
                           us * 1e-6]).astype(np.float32)


def _fe_edges_phase():
    """(a) ``aggregate_window`` on the card bit-equal to the CPU where the
    time bin's rounding matters: times on and beside the bin edges, and
    whole microseconds, at each of ``FE_EDGE_CASES`` (the CPU is held to
    ``repro`` there by tests/test_torch_events.py). Also counts the times
    that a Python-float divisor (which PyTorch's CUDA kernel turns into a
    product by the reciprocal) would bin otherwise on the card than on
    the CPU; that count is read, not held."""
    from repro_torch import convert
    from repro_torch.core import events

    height, width = 16, 16
    n_times = scalar_differ = 0
    for dt, t_bins in FE_EDGE_CASES:
        t = _fe_edge_times(dt, t_bins)
        n = t.size
        ev = convert.event_batch_from_numpy(
            x=np.arange(n) % width, y=(np.arange(n) // width) % height, t=t,
            p=np.arange(n) % 2, count=n)
        got = events.aggregate_window(ev.to("cuda"), dt, t_bins, height,
                                      width)
        want = events.aggregate_window(ev, dt, t_bins, height, width)
        if not bits_equal(got, want):
            raise AssertionError(f"events: aggregate_window at the bin "
                                 f"edges, dt {dt}, T_bins {t_bins} != the "
                                 f"CPU")
        card = (ev.t.cuda() / dt * t_bins).to(torch.int32).cpu()
        scalar_differ += int((card != (ev.t / dt * t_bins).to(
            torch.int32)).sum())
        n_times += n
    log(f"[front end] (a) aggregate_window at the bin edges ({n_times} "
        f"times on, beside and between the edges, whole microseconds, "
        f"(dt, T_bins) in {FE_EDGE_CASES}): bit-equal to the CPU; a Python-"
        f"float divisor would bin {scalar_differ} of them otherwise on the "
        f"card")


def _fe_guard(gen) -> dict:
    """Under cuDNN's global TF32 flag (set by the caller): how far an
    unguarded ``F.conv2d`` lies from FP32 at the encoder's two convolutions
    (random weights, 0/1 inputs as the spikes are) and at a wider one, and
    how far ``encoder.conv_same`` (the guarded path) lies from FP32 there;
    ``scale`` is the FP32 result's largest magnitude."""
    import torch.nn.functional as F

    from repro_torch.core import encoder

    def case(n, c_in, c_out, size):
        x = (torch.rand((n, c_in, size, size), generator=gen) < 0.3
             ).float().cuda()
        w = (torch.randn((c_out, c_in, 3, 3), generator=gen)
             / np.sqrt(9 * c_in)).cuda()
        return x, w, F.pad(x, (0, 1, 0, 1))   # XLA's "SAME" at stride 2

    out = {}
    for name, shape in (("conv1", (512, 2, 16, 32)),
                        ("conv2", (128, 16, 32, 16)),
                        ("wide", FE_WIDE_CONV)):
        x, w, xp = case(*shape)
        flagged = F.conv2d(xp, w, stride=2)
        with _fe_flag(False):
            fp32 = F.conv2d(xp, w, stride=2)
        out[name] = float((flagged - fp32).abs().max())
    out["guarded"] = float((encoder.conv_same(x, w, 2) - fp32).abs().max())
    out["scale"] = float(fp32.abs().max())
    return out


@contextlib.contextmanager
def _fe_flag(tf32: bool):
    """cuDNN's global TF32 flag set to ``tf32``, then put back."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def _fe_margins(enc, vols, cfg) -> torch.Tensor:
    """Per proposal, the least |v - thresh| of any membrane potential at any
    bin: ``encoder.encode_batch``'s steps (``conv_same``, ``spike``, the
    soft reset) run again on ``vols``' device, float32 [N]."""
    from repro_torch.core import encoder

    N, T, H, W, _ = vols.shape
    with torch.no_grad():
        x = vols.permute(0, 1, 4, 2, 3).reshape(N * T, 2, H, W)
        c1 = encoder.conv_same(x, enc.conv1, 2)
        c1 = c1.reshape(N, T, *c1.shape[1:])
        v1, v2 = torch.zeros_like(c1[:, 0]), 0.0
        margin = torch.full((N,), float("inf"), device=vols.device)
        for t in range(T):
            v1 = cfg.tau * v1 + c1[:, t]
            s1 = encoder.spike(v1 - cfg.thresh)
            v2 = cfg.tau * v2 + encoder.conv_same(s1, enc.conv2, 2)
            s2 = encoder.spike(v2 - cfg.thresh)
            for v in (v1, v2):
                near = torch.abs(v - cfg.thresh).flatten(1).amin(dim=1)
                margin = torch.minimum(margin, near)
            v1 = v1 - s1 * cfg.thresh
            v2 = v2 - s2 * cfg.thresh
    return margin


def _fe_grads(enc, vols, img, bank, labels, cfg, tf32):
    """The bridge loss and its gradients through the encoder."""
    from repro_torch.core import bridge, encoder

    with _fe_flag(tf32):
        loss, _ = bridge.bridge_loss(img, encoder.encode_batch(enc, vols, cfg),
                                     bank, labels)
        params = dict(enc.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _fe_encoder_phase(report):
    """(b) ``encode_batch`` over 128 proposals at ``EncoderConfig()`` (c1
    16, c2 32, feat_dim 512) on volumes aggregated on the card, with
    cuDNN's global TF32 flag set to True around every call (the encoder's
    own guard must keep it FP32): z_e held to the CPU per proposal (rtol
    and atol 1e-5; a proposal whose CPU potential came within 1e-4 of the
    threshold at some bin may miss it, at most 1 %), the bridge loss's
    gradients per tensor (on the proposals not excused), and ``query_hv``
    with torr_edge's R (D = 8192) by the agreement rule, with its
    ``sign_project`` launches counted."""
    import torch.nn.functional as F

    from repro_torch.configs.torr_edge import torr_edge
    from repro_torch.core import bridge, encoder, events
    from repro_torch.kernels import build, ref

    cfg = encoder.EncoderConfig()
    gen = torch.Generator().manual_seed(20)
    enc_cpu = encoder.init_encoder(cfg, gen)
    enc = copy.deepcopy(enc_cpu).to("cuda")
    T, H, W = FE_WINDOW
    evs = [_fe_events(7000 + i, FE_EVENTS, H, W).to("cuda")
           for i in range(FE_PROPOSALS)]
    vols = torch.stack([events.aggregate_window(e, FE_DT, T, H, W)
                        for e in evs])
    vols_cpu = torch.stack([events.aggregate_window(e.to("cpu"), FE_DT, T,
                                                    H, W) for e in evs])
    if not bits_equal(vols, vols_cpu):
        raise AssertionError("encoder: the card's volumes != the CPU's")
    margin = _fe_margins(enc_cpu, vols_cpu, cfg)
    with torch.no_grad():
        z_cpu = encoder.encode_batch(enc_cpu, vols_cpu, cfg)
        with _fe_flag(True):
            z = encoder.encode_batch(enc, vols, cfg)
            enc_sp = spread(cuda_times(
                lambda: encoder.encode_batch(enc, vols, cfg)))
            enc_dev = device_ms(lambda: encoder.encode_batch(enc, vols, cfg))
            guard = _fe_guard(gen)
    ok = torch.isclose(z.cpu(), z_cpu, rtol=FE_TOL, atol=FE_TOL).all(dim=1)
    missed = torch.nonzero(~ok).flatten()
    if bool((margin[missed] >= FE_EXCUSE).any()) or \
            missed.numel() > 0.01 * FE_PROPOSALS:
        raise AssertionError(f"encoder: proposals {missed.tolist()} miss "
                             f"the tolerance, margins "
                             f"{margin[missed].tolist()}")
    err = float((z.cpu() - z_cpu).abs().max())
    log(f"[front end] (b) encode_batch {tuple(vols.shape)} -> "
        f"{tuple(z.shape)} with cudnn.allow_tf32=True: {missed.numel()} "
        f"proposals excused (margins {margin[missed].tolist()}), "
        f"{int((margin < FE_EXCUSE).sum())} within {FE_EXCUSE} of the "
        f"threshold, max |z_card - z_cpu| {err:.3e}; encode_batch from an "
        f"idle stream (CUDA events) {fmt_spread(enc_sp)}, "
        f"{enc_dev:.4f} ms on the device (captured); under the flag, "
        f"|F.conv2d - FP32| {guard['conv1']:.3e} at conv1, "
        f"{guard['conv2']:.3e} at conv2, {guard['wide']:.3e} at "
        f"{FE_WIDE_CONV}; |conv_same - FP32| {guard['guarded']:.3e} there")
    if guard["guarded"] > FE_TOL * guard["scale"]:
        raise AssertionError(f"encoder: the FP32 guard let TF32 through "
                             f"{guard}")

    # the bridge loss's gradients, on the proposals not excused
    keep = torch.nonzero(ok).flatten()
    proxy = bridge.make_frozen_proxy(8, cfg.feat_dim, generator=gen)
    labels = torch.randint(0, 8, (FE_PROPOSALS,), generator=gen)[keep]
    img = proxy(F.one_hot(labels, 8).float())
    bank = torch.randn((8, cfg.feat_dim), generator=gen)
    l_cpu, g_cpu = _fe_grads(enc_cpu, vols_cpu[keep], img, bank, labels,
                             cfg, False)
    l_card, g_card = _fe_grads(enc, vols[keep.cuda()], img.cuda(),
                               bank.cuda(), labels.cuda(), cfg, True)
    rel = {k: float(torch.linalg.vector_norm(g_card[k].cpu() - g_cpu[k])
                    / torch.linalg.vector_norm(g_cpu[k])) for k in g_cpu}
    if any(not r <= FE_GRAD_TOL for r in rel.values()) or not math.isclose(
            float(l_card), float(l_cpu), rel_tol=FE_TOL):
        raise AssertionError(f"encoder: bridge gradients {rel}, loss "
                             f"{float(l_card)} vs {float(l_cpu)}")
    log(f"[front end] (b) bridge loss {float(l_card):.6f} (CPU "
        f"{float(l_cpu):.6f}) over {keep.numel()} proposals; gradient "
        f"||card - cpu|| / ||cpu|| " + ", ".join(
            f"{k} {r:.2e}" for k, r in rel.items()))

    # q = sign(R z_e) through the sign_project kernel
    R = encoder.make_projection(torr_edge().D, cfg.feat_dim, gen)
    R_card = R.cuda()
    build.reset_launches()
    q = encoder.query_hv(enc, vols, R_card, cfg)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    _require_launched("query_hv", launches, ("sign_project",))
    rule = ref.sign_disagreement(z.cpu(), R, q.cpu(),
                                 ref.sign_project_ref(z.cpu(), R))
    if not rule["ok"] or rule["decided_differ"]:
        raise AssertionError(f"query_hv breaks the agreement rule {rule}")
    report["sign_project"].setdefault("front_end_launches", {})[
        "query_hv"] = launches["sign_project"]
    log(f"[front end] (b) query_hv {tuple(q.shape)} int8 (R {tuple(R.shape)}"
        f"): decided_differ {rule['decided_differ']} undecided_differ "
        f"{rule['undecided_differ']}; launches {launches}")
    return dict(encode_batch_ms=enc_sp, encode_batch_device_ms=enc_dev,
                excused=int(missed.numel()),
                grad_rel=rel, tf32_flag=guard,
                query_hv_launches=launches["sign_project"])


def _fe_trainer_phase():
    """(c) ``examples.train_bridge.main([])`` on the card: the reference's
    defaults and its convergence assertion."""
    from repro_torch.examples import train_bridge

    t0 = time.perf_counter()
    res = train_bridge.main([])
    wall = time.perf_counter() - t0
    step_sp = spread([1e3 * s for s in res["step_s"][1:]])
    log(f"[front end] (c) train_bridge on {res['device']}: zero-shot "
        f"accuracy {res['first']:.2f} -> {res['last']:.2f}, "
        f"{res['s_per_step']:.4f} s/step mean; a step after the first "
        f"(wall, host read included) {fmt_spread(step_sp)}; "
        f"{len(res['accs'])} steps, {wall:.2f} s")
    return dict(first=res["first"], last=res["last"],
                s_per_step=res["s_per_step"], step_ms=step_sp)


def _rr_hidden(rng):
    """Hidden states that drift slowly and jump at ``RR_JUMPS``."""
    h = rng.standard_normal((RR_BATCH, RR_D_MODEL))
    out = []
    for t in range(RR_STEPS):
        h = (rng.standard_normal(h.shape) if t in RR_JUMPS
             else h + 0.05 * rng.standard_normal(h.shape))
        out.append(torch.from_numpy(h.astype(np.float32)))
    return out


def _fe_reranker_phase(report):
    """(d) 32 decode steps of ``rerank_step`` at qwen3-14b's widths on the
    card: each step's packed q held to the CPU's encode by the agreement
    rule; the CPU's ``_rerank_from_packed`` fed the card's q equals the
    card's rho, bypassed, state and scores bit for bit and its logits to
    rtol 1e-5; both paths occur; ``sign_project_pack`` and
    ``packed_hamming_batched`` launched once a step."""
    from repro_torch.core.types import TorrConfig
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels.xnor_popcount_sim import packed_hamming_batched
    from repro_torch.serving import reranker as rr

    rcfg = TorrConfig(D=2048, B=8, M=min(RR_VOCAB, 256), K=8, N_max=RR_BATCH,
                      feat_dim=RR_D_MODEL)
    t0 = time.perf_counter()
    params, im = rr.init_reranker(rcfg, RR_D_MODEL, RR_VOCAB, alpha=0.5,
                                  generator=torch.Generator().manual_seed(7))
    p_card, im_card = params.to("cuda"), im.to("cuda")
    rng = np.random.default_rng(8)
    hidden = _rr_hidden(rng)
    logits = [torch.from_numpy(rng.standard_normal(
        (RR_BATCH, RR_VOCAB)).astype(np.float32)) for _ in range(RR_STEPS)]
    setup_s = time.perf_counter() - t0
    h_card = [h.cuda() for h in hidden]
    l_card = [x.cuda() for x in logits]

    def run(steps):
        st = rr.init_state(rcfg, RR_BATCH, "cuda")
        outs = []
        for t in steps:
            lg, st, tel = rr.rerank_step(p_card, st, im_card, h_card[t],
                                         l_card[t], rcfg)
            outs.append((lg, st, tel))
        return outs

    run(range(2))                                   # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outs = run(range(RR_STEPS))
    torch.cuda.synchronize()
    walls = [(time.perf_counter() - t0) * 1e3 / RR_STEPS]
    launches = dict(build.LAUNCHES)
    for _ in range(RR_LOOPS - 1):
        t0 = time.perf_counter()
        run(range(RR_STEPS))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / RR_STEPS)
    wall_sp = spread(walls)
    for name in ("sign_project_pack", "packed_hamming_batched"):
        if launches[name] != RR_STEPS:
            raise AssertionError(f"rerank: {name} launched "
                                 f"{launches[name]} times in {RR_STEPS} "
                                 "steps")
        report[name].setdefault("front_end_launches", {})["rerank_step"] = \
            launches[name]

    st = rr.init_state(rcfg, RR_BATCH, "cpu")
    undecided = 0
    for t, (lg, st_card, tel) in enumerate(outs):
        qp = st_card.prev_q.cpu()
        rule = ref.sign_pack_disagreement(
            hidden[t], params.R, qp,
            ops.encode_packed(hidden[t], params.R, device="cpu"))
        if not rule["ok"] or rule["decided_differ"]:
            raise AssertionError(f"rerank step {t}: q breaks the agreement "
                                 f"rule {rule}")
        undecided += rule["undecided_differ"]
        lg_cpu, st, tel_cpu = rr._rerank_from_packed(params, st, im, qp,
                                                     logits[t], rcfg)
        for what, a, b in (("rho", tel["rho"], tel_cpu["rho"]),
                           ("bypassed", tel["bypassed"],
                            tel_cpu["bypassed"]),
                           ("prev_s", st_card.prev_s, st.prev_s),
                           ("valid", st_card.valid, st.valid)):
            if not bits_equal(a, b):
                raise AssertionError(f"rerank step {t}: {what} != the CPU")
        if not torch.allclose(lg.cpu(), lg_cpu, rtol=RR_LOGIT_RTOL,
                              atol=1e-6):
            raise AssertionError(f"rerank step {t}: logits != the CPU")
    byp = torch.stack([o[2]["bypassed"] for o in outs]).cpu()
    bypass_rate = float(byp.float().mean())
    if not bool(byp.any()) or int((~byp[1:]).sum()) == 0:
        raise AssertionError("rerank: no bypass or no full step after the "
                             "first")

    # one steady step's device time (captured, so the host's launches are
    # not counted), and the two kernels at its shapes
    st0 = outs[-1][1]
    step_dev = device_ms(lambda: rr.rerank_step(p_card, st0, im_card,
                                                h_card[-1], l_card[-1],
                                                rcfg))
    R32 = p_card.R
    enc_ms = device_ms(lambda: fw.sign_project_pack(h_card[-1], R32))
    enc_b = _encode_bounds(RR_BATCH, RR_D_MODEL, rcfg.D,
                           RR_BATCH * rcfg.D // 8)[0]
    qp = st0.prev_q
    ham_ms = device_ms(lambda: packed_hamming_batched(qp, im_card.packed))
    pairs = RR_BATCH * rcfg.M * rcfg.words
    ham_b = bound(4 * (qp.numel() + im_card.packed.numel()
                       + RR_BATCH * rcfg.M), pairs * 64 / PEAK_B1_S)
    log(f"[front end] (d) rerank_step x {RR_STEPS} at d_model {RR_D_MODEL}, "
        f"vocab {RR_VOCAB}, batch {RR_BATCH} (D {rcfg.D}, B {rcfg.B}, M "
        f"{rcfg.M}): wall a step over the loop {fmt_spread(wall_sp)}, "
        f"{step_dev:.4f} ms a step on the device (captured); bypass rate "
        f"{bypass_rate:.4f} "
        f"({int(byp.sum())} of {byp.numel()}); q undecided_differ "
        f"{undecided}, rho/bypassed/state bit-equal to the CPU fed the "
        f"card's q, logits within rtol {RR_LOGIT_RTOL}; launches {launches}; "
        f"setup {setup_s:.2f} s")
    log(f"[time] sign_project_pack(N={RR_BATCH},d={RR_D_MODEL},D={rcfg.D}): "
        f"{enc_ms:.4f} ms on the device, bound {enc_b[0]:.4f} ms "
        f"({enc_b[1]}); packed_hamming_batched(N={RR_BATCH},M={rcfg.M},"
        f"W={rcfg.words}): {ham_ms:.4f} ms, bound {ham_b[0]:.4f} ms "
        f"({ham_b[1]})")
    return dict(ms_per_step=wall_sp, step_device_ms=step_dev,
                bypass_rate=bypass_rate, launches={
                    k: launches[k] for k in ("sign_project_pack",
                                             "packed_hamming_batched")},
                sign_project_pack_ms=enc_ms,
                sign_project_pack_bound_ms=enc_b[0],
                packed_hamming_batched_ms=ham_ms,
                packed_hamming_batched_bound_ms=ham_b[0])


def phase_front_end(report):
    """Phase 14 (after 13, before 10): (a) events, (b) the encoder, (c) the
    bridge trainer, (d) the reranker; see each step."""
    _fe_events_phase()
    row = {"encoder": _fe_encoder_phase(report)}
    row["trainer"] = _fe_trainer_phase()
    row["reranker"] = _fe_reranker_phase(report)
    return row


# phase 15: qwen3-14b at its full config (src/repro/configs/registry.py:68)
# served as the launcher serves it (src/repro/launch/serve.py:882-944)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen3-14b", 4, 128, 32
# (b): full widths, depth cut to these layers (the VLM: one group, four self
# layers and its cross layer; deepseek-v2: its dense layer and one MoE layer)
LM_DEPTHS = (("qwen3-14b", 2), ("musicgen-large", 2),
             ("llama-3.2-vision-90b", 5), ("deepseek-v2-236b", 2))
LM_CONT_TOL = 2e-2          # (b): tests/test_models.py's rule
LM_SMOKE_TOL = 1e-3         # (c): tests/test_torch_lm.py's float32 rule
LM_SMOKE_STEPS = 4


@contextlib.contextmanager
def _lm_flags():
    """GEMMs in float32 without TF32 and without reduced-precision
    reductions in bfloat16 and float16 (PyTorch enables those by default),
    then the flags as they were."""
    m = torch.backends.cuda.matmul
    names = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
             "allow_fp16_reduced_precision_reduction")
    was = {n: getattr(m, n) for n in names}
    for n in names:
        setattr(m, n, False)
    try:
        yield "TF32 off, bf16/fp16 reduced-precision reduction off"
    finally:
        for n, v in was.items():
            setattr(m, n, v)


def _lm_offsets(params, gen):
    """Every vector leaf (the norm offsets and the VLM's gate, zero at
    init) drawn N(0, 0.3^2), so the norms' scales and the cross layer
    count (tanh(0) = 0 would hide the cross layer)."""
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() == 1:
                p.copy_(0.3 * torch.randn(p.shape, generator=gen,
                                          device=p.device).to(p))


def _lm_leaves(tree):
    """The tensors of a decode cache (its keys in order) or of a tuple."""
    from repro_torch.core.capture import leaves

    if isinstance(tree, dict):
        tree = tuple(tree[k] for k in sorted(tree))
    return leaves(tree)


def _lm_serving(report, flags):
    """(a) ``run_lm`` at qwen3-14b's full config with the reranker and the
    captured decode step, then the same tokens replayed eagerly: every
    step's logits and hidden state and the final cache bit-equal; both
    reranker kernels launched once a reranked step."""
    import gc

    from repro_torch.core import capture
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    res = serve.run_lm(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                       gen=LM_GEN, rerank=True, record=True)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reranked = LM_GEN - 1
    for name in ("sign_project_pack", "packed_hamming_batched"):
        if launches[name] != reranked or res["launches"][name] != reranked:
            raise AssertionError(f"lm: {name} launched {launches[name]} "
                                 f"times ({res['launches'][name]} after the "
                                 f"warm-up) in {reranked} reranked steps")
        report[name]["lm_launches"] = {"run_lm": launches[name]}
    cfg, params, fam = res["cfg"], res["params"], res["graphs"]
    if not isinstance(fam, capture.GraphFamily) or len(fam) != 1 or \
            fam.replays != LM_GEN:
        raise AssertionError("lm: the decode step was not replayed from "
                             "one graph every step")
    n_params = sum(p.numel() for p in params.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in params.parameters()) / 1e9

    # the same tokens, eagerly; then the captured step alone on them
    s_max = LM_PROMPT + 64
    toks = torch.from_numpy(res["tokens"]).cuda()
    cache, _ = tf.prefill(params, res["prompt"], cfg, s_max=s_max)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LM_GEN):
        cache, lg, h = tf.decode_step(params, cache, toks[:, t], cfg,
                                      return_hidden=True)
        outs.append((lg, h))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / LM_GEN
    for t, ((lg, h), (lg_c, h_c)) in enumerate(zip(outs, res["steps"])):
        if not (bits_equal(lg, lg_c) and bits_equal(h, h_c)):
            raise AssertionError(f"lm: eager step {t} != the captured step")
    for a, b in zip(_lm_leaves(cache), _lm_leaves(res["cache"])):
        if not bits_equal(a, b):
            raise AssertionError("lm: the eager cache != the captured one")
    key = (serve.LM_DECODE, cfg, LM_BATCH, s_max)
    names = tuple(res["cache"])
    step = serve._decode_segment(params, cfg, names)
    leaves = tuple(res["cache"][n] for n in names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LM_GEN):
        leaves, _, _ = fam.run(key, step, (leaves, toks[:, t]))
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / LM_GEN
    cache_leaves = _lm_leaves(leaves)
    cache_mb = sum(x.numel() * x.element_size() for x in cache_leaves) / 1e6
    copy_ms = device_ms(lambda: [x.clone() for x in cache_leaves], calls=5)
    bound_ms = weight_gb * 1e9 / PEAK_BYTES_S * 1e3
    log(f"[lm] (a) {cfg.name} full config ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, vocab "
        f"{cfg.vocab}, {cfg.dtype}): {n_params / 1e9:.2f}B parameters, "
        f"{weight_gb:.2f} GB of weights drawn on the card; batch "
        f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} tokens, reranked; "
        f"{flags}")
    log(f"[lm] (a) recording every step's outputs: prefill "
        f"{res['prefill_ms']:.2f} ms (the first call); decode "
        f"{res['decode_ms_per_token']:.3f} ms/token; first step (capture) "
        f"{res['first_step_ms']:.1f} ms; bypass rate "
        f"{res['bypass_rate']:.4f}; peak memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"[lm] (a) decode step alone on the same tokens: captured (copy in, "
        f"replay, clone out) {replay_ms:.3f} ms/token, eager "
        f"{eager_ms:.3f} ms/token; weights read once {bound_ms:.3f} ms at "
        f"{PEAK_BYTES_S / 1e12:.2f} TB/s; the cache {cache_mb:.1f} MB, one "
        f"copy of it {copy_ms:.4f} ms on the device (two a replay); eager "
        f"== captured bit for bit in {LM_GEN} steps' logits and hidden "
        f"states and the final cache; launches {launches}")
    row = dict(arch=cfg.name, n_params=n_params, weight_gb=weight_gb,
               recorded=dict(prefill_ms=res["prefill_ms"],
                             decode_ms_per_token=res["decode_ms_per_token"],
                             first_step_ms=res["first_step_ms"]),
               bypass_rate=res["bypass_rate"], peak_gib=peak / 2**30,
               replay_ms=replay_ms, eager_ms=eager_ms,
               weights_bound_ms=bound_ms, cache_mb=cache_mb,
               cache_copy_ms=copy_ms, launches={
                   k: launches[k] for k in ("sign_project_pack",
                                            "packed_hamming_batched")})
    del res, params, fam, cache, outs, leaves, cache_leaves, step
    # the launcher's run as a user makes it (nothing recorded), with and
    # without the reranker: what the reranker's step costs
    for rerank in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        run = serve.run_lm(LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
                           gen=LM_GEN, rerank=rerank)
        label = "reranked" if rerank else "not reranked"
        row[label] = {k: run[k] for k in ("prefill_ms", "first_step_ms",
                                          "decode_ms_per_token", "tok_s")}
        log(f"[lm] (a) {label}: prefill {run['prefill_ms']:.2f} ms; decode "
            f"(captured, with sampling) {run['decode_ms_per_token']:.3f} "
            f"ms/token, {run['tok_s']:.1f} tok/s; first step (capture) "
            f"{run['first_step_ms']:.1f} ms")
        del run
    return row


def _lm_prompt(cfg, B, S, seed, device):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, shape).astype(np.int32)).to(device)}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
        ).to(device)
    return batch


def _lm_continuation():
    """(b) Full widths at reduced depth, float32: prefill(t[:16]) then
    decode(t[16]) equals prefill(t[:17]) within 2e-2."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as tf

    rows = []
    for name, depth in LM_DEPTHS:
        # deepseek-v2: a capacity no run drops from (prefill's capacity and
        # token order change with the prompt's length)
        over = dict(capacity_factor=8.0) if name.startswith("deepseek") \
            else {}
        cfg = dataclasses.replace(get(name), n_layers=depth, dtype="float32",
                                  **over)
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator("cuda").manual_seed(2),
                                "cuda")
        _lm_offsets(params, torch.Generator("cuda").manual_seed(3))
        batch = _lm_prompt(cfg, 2, 17, 4, "cuda")
        short = {k: (v[:, :16] if k == "tokens" else v)
                 for k, v in batch.items()}
        cache, _ = tf.prefill(params, short, cfg)
        _, dec = tf.decode_step(params, cache, batch["tokens"][:, 16], cfg)
        _, full = tf.prefill(params, batch, cfg)
        err = float((dec - full).abs().max())
        # MLA: 2e-2 of the logits' scale (its absorbed decode and its
        # prefill round one score to bfloat16 in two ways; tests/
        # test_torch_lm.py::test_decode_matches_prefill_continuation)
        atol = LM_CONT_TOL * (float(full.abs().max())
                              if cfg.attn_kind == "mla" else 1.0)
        ok = torch.allclose(dec, full, rtol=LM_CONT_TOL, atol=atol)
        secs = time.perf_counter() - t0
        extra = ", capacity_factor 8" if over else ""
        log(f"[lm] (b) {name} at {depth} of {get(name).n_layers} layers, "
            f"d_model {cfg.d_model}, float32{extra}: decode after prefill "
            f"vs prefill of the longer prompt, max |diff| {err:.3e} (rule "
            f"rtol {LM_CONT_TOL}, atol {atol:.3e}); {secs:.1f} s")
        if not ok:
            raise AssertionError(f"lm: {name} decode != prefill "
                                 f"continuation ({err})")
        rows.append(dict(arch=name, layers=depth, max_abs_diff=err,
                         atol=atol))
        del params, cache
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _lm_scores(dtype):
    """The score products' operand type in ``models/attention.py`` and
    ``models/mla.py`` (bfloat16, as the reference rounds q and k) set to
    ``dtype``, then put back."""
    from repro_torch.models import attention, mla

    was = attention.BF16, mla.BF16
    attention.BF16 = mla.BF16 = dtype
    try:
        yield
    finally:
        attention.BF16, mla.BF16 = was


def _lm_card_vs_cpu():
    """(c) Smoke configs of the four families in float32, every vector
    leaf drawn: the card's prefill and 4 teacher-forced decode steps (logits,
    hidden, cache) against the port's CPU run. With the score products in
    float32 at the CPU tests' 1e-3; as the model computes them (q and k
    rounded to bfloat16, a bfloat16 product) at 1e-3 widened to one
    bfloat16 ulp of each tensor's scale (2^-8 max|cpu|): where the card's
    and the CPU's float32 sums round to two bfloat16 values a score moves by
    an ulp."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        with _lm_scores(dtype):
            rows += _lm_card_vs_cpu_at(dtype)
    return rows


def _lm_card_vs_cpu_at(score_dtype, names=tuple(n for n, _ in LM_DEPTHS),
                      S=16, tag="(c)"):
    from repro_torch.configs import get_smoke
    from repro_torch.core import capture
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    rows = []
    scores = str(score_dtype).removeprefix("torch.")
    for name in names:
        cfg = dataclasses.replace(get_smoke(name), dtype="float32")
        cpu = tf.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        _lm_offsets(cpu, torch.Generator().manual_seed(6))
        card = copy.deepcopy(cpu).to("cuda")
        batch = _lm_prompt(cfg, 2, S + LM_SMOKE_STEPS, 7, "cpu")
        short = {k: (v[:, :S] if k == "tokens" else v)
                 for k, v in batch.items()}
        c_cpu, l_cpu = tf.prefill(cpu, short, cfg)
        c_card, l_card = tf.prefill(card, {k: v.cuda()
                                           for k, v in short.items()}, cfg)
        # the same steps replayed from a CUDA graph, as run_lm decodes
        names = tuple(c_card)
        step = serve._decode_segment(card, cfg, names)
        fam = capture.GraphFamily()
        graphed = tuple(capture.tree_map(torch.clone, c_card[n])
                        for n in names)
        pairs = [("prefill logits", l_card, l_cpu)]
        for t in range(LM_SMOKE_STEPS):
            tok = batch["tokens"][:, S + t]
            c_cpu, lc, hc = tf.decode_step(cpu, c_cpu, tok, cfg,
                                           return_hidden=True)
            c_card, lg, hg = tf.decode_step(card, c_card, tok.cuda(), cfg,
                                            return_hidden=True)
            graphed, lgg, hgg = fam.run((serve.LM_DECODE, cfg, 2, 16 + 64),
                                        step, (graphed, tok.cuda()))
            if not (bits_equal(lgg, lg) and bits_equal(hgg, hg)):
                raise AssertionError(f"lm: {name} smoke ({scores} scores) "
                                     f"step {t}: captured != eager")
            pairs += [(f"step {t} logits", lg, lc), (f"step {t} hidden", hg,
                                                     hc)]
        if not all(bits_equal(a, b) for a, b in zip(
                _lm_leaves(graphed), _lm_leaves(tuple(c_card[n]
                                                      for n in names)))):
            raise AssertionError(f"lm: {name} smoke: the captured cache != "
                                 "the eager one")
        pairs += [(f"cache {i}", a, b) for i, (a, b) in enumerate(zip(
            _lm_leaves(c_card), _lm_leaves(c_cpu)))]
        err = 0.0
        for what, a, b in pairs:
            a, b = a.cpu().float(), b.float()
            err = max(err, float((a - b).abs().max()))
            atol = LM_SMOKE_TOL
            if score_dtype == torch.bfloat16:
                atol = max(atol, 2.0 ** -8 * float(b.abs().max()))
            if not torch.allclose(a, b, rtol=LM_SMOKE_TOL, atol=atol):
                raise AssertionError(f"lm: {name} smoke ({scores} scores) "
                                     f"{what} card != cpu")
        rule = (f"{LM_SMOKE_TOL}" if score_dtype == torch.float32 else
                f"{LM_SMOKE_TOL}, widened to 2^-8 of each tensor's scale")
        log(f"[lm] {tag} {name} smoke, float32, {scores} scores: prefill of "
            f"{S} and {LM_SMOKE_STEPS} decode steps on the card == the CPU "
            f"within "
            f"{rule} (max |diff| {err:.3e} over logits, hidden and cache); "
            f"the steps replayed from a CUDA graph == eager bit for bit")
        rows.append(dict(arch=name, scores=scores, max_abs_diff=err))
    return rows


def _lm_cli():
    """(d) The launcher as a user runs it, in a subprocess, at
    musicgen-large's full config."""
    import os
    import subprocess

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "musicgen-large", "--batch", "2", "--prompt-len", "16", "--gen",
           "8"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(
                             ROOT / "src")))
    secs = time.perf_counter() - t0
    if out.returncode != 0 or "generated shape (2, 8, 4)" not in out.stdout:
        raise AssertionError(f"lm: the launcher failed ({out.returncode}): "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("[serve]"):
            log(f"[lm] (d) {line}")
    log(f"[lm] (d) python -m repro_torch.launch.serve --arch musicgen-large "
        f"--batch 2 --prompt-len 16 --gen 8: exit 0, {secs:.1f} s")
    return dict(seconds=secs)


def phase_lm(report):
    """Phase 15 (after 14, before 10): (a) qwen3-14b at its full config
    served with the reranker, captured == eager; (b) full widths at reduced
    depth, decode == prefill continuation; (c) the four families' smoke
    configs, card == CPU; (d) the CLI at musicgen-large's full config. The
    weights are freed before phase 10."""
    import gc

    with _lm_flags() as flags:
        row = {"flags": flags, "serve": _lm_serving(report, flags)}
        gc.collect()
        torch.cuda.empty_cache()
        row["continuation"] = _lm_continuation()
        row["card_vs_cpu"] = _lm_card_vs_cpu()
    row["cli"] = _lm_cli()
    gc.collect()
    torch.cuda.empty_cache()
    return row


# phase 16: the recurrent families at their full configs
# (src/repro/configs/registry.py: recurrentgemma-2b, xlstm-1.3b) served as
# the launcher serves them, and the int8 cache's decode
REC_ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")
REC_BATCH, REC_PROMPT, REC_GEN = 4, 128, 32
# (b): published widths, depth cut to one group (the hybrid's rglru,
# rglru, local_attn; the ssm's seven mLSTM layers and its sLSTM layer)
REC_DEPTHS = (("recurrentgemma-2b", 3), ("xlstm-1.3b", 8))
REC_SMOKE_PROMPT = 32       # (c): longer than the hybrid's smoke window 16
# (d): int8 decode from init_cache, T tokens into a cache of S_MAX slots
INT8_MODELS = (("qwen3-14b", None), ("deepseek-v2-236b", 2))
INT8_T, INT8_S_MAX = 16, 64
INT8_SOFTMAX_TOL = 0.05     # tests/test_beyond_paper.py's criterion


def _state_bytes(cache) -> int:
    from repro_torch.core.capture import leaves

    return sum(t.numel() * t.element_size() for t in leaves(
        {k: v for k, v in cache.items() if k != "pos"}))


def _step_bytes(params, cache, cfg, B) -> float:
    """The least bytes a decode step moves: every weight read once (an
    untied embedding only at the batch's B rows; a tied one is read whole
    as the unembedding) and every cache leaf read and written once."""
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    if "unembed" in params:
        e = params.embed
        weights -= e.numel() * e.element_size()
        weights += B * e.shape[-1] * e.element_size()
    return weights + 2 * _state_bytes(cache)


def _slstm_prefill(params, cfg, prefill_ms):
    """xlstm: one sLSTM layer's prefill alone at the run's shape (the loop
    over the prompt, a few launches a token): its wall time (warm, to a
    sync), then under torch.profiler its device kernels and their busy
    time; times the model's sLSTM layers, against the whole prefill."""
    from repro_torch.models import recurrent as rec

    p = params.groups[0][f"slstm_{cfg.slstm_every - 1}"].cell
    x = torch.randn((REC_BATCH, REC_PROMPT, cfg.d_model),
                    generator=torch.Generator("cuda").manual_seed(12),
                    device="cuda").to(torch.bfloat16)
    rec.slstm_prefill(p, x, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.slstm_prefill(p, x, cfg)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rec.slstm_prefill(p, x, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.duration_ns() for e in kernels) / 1e6
    n = len(params.groups)
    row = dict(layer_wall_ms=wall_ms, layer_kernels=len(kernels),
               layer_busy_ms=busy_ms, layers=n, wall_ms=n * wall_ms,
               kernels=n * len(kernels), share_of_prefill=n * wall_ms
               / prefill_ms)
    log(f"[recurrent] (a) {cfg.name}: one sLSTM layer's prefill of "
        f"{REC_PROMPT} tokens (batch {REC_BATCH}): {wall_ms:.2f} ms wall, "
        f"{len(kernels)} kernels ({len(kernels) / REC_PROMPT:.1f} a token) "
        f"busy {busy_ms:.3f} ms on the device (torch.profiler); x {n} "
        f"layers: {n * wall_ms:.1f} ms, {100 * row['share_of_prefill']:.0f} "
        f"% of the warm prefill ({prefill_ms:.1f} ms)")
    return row


def _rec_serving(arch, report):
    """(a) ``run_lm`` at ``arch``'s full config, reranked, the decode step
    captured; the same tokens eagerly, bit-equal to the captured run;
    prefill again warm; the captured step alone and the cache's copy."""
    import gc

    from repro_torch.core import capture
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    res = serve.run_lm(arch, batch=REC_BATCH, prompt_len=REC_PROMPT,
                       gen=REC_GEN, rerank=True, record=True)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reranked = REC_GEN - 1
    for name in ("sign_project_pack", "packed_hamming_batched"):
        if launches[name] != reranked:
            raise AssertionError(f"recurrent: {arch}: {name} launched "
                                 f"{launches[name]} times in {reranked} "
                                 "reranked steps")
        report[name].setdefault("phase16_launches", {})[arch] = \
            launches[name]
    cfg, params, fam = res["cfg"], res["params"], res["graphs"]
    if not isinstance(fam, capture.GraphFamily) or len(fam) != 1 or \
            fam.replays != REC_GEN:
        raise AssertionError(f"recurrent: {arch}: the decode step was not "
                             "replayed from one graph every step")
    n_params = sum(p.numel() for p in params.parameters())
    # prefill again (warm), then the same tokens eagerly
    toks = torch.from_numpy(res["tokens"]).cuda()
    s_max = REC_PROMPT + 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, _ = tf.prefill(params, res["prompt"], cfg, s_max=s_max)
    torch.cuda.synchronize()
    prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    slstm = (_slstm_prefill(params, cfg, prefill_warm_ms)
             if cfg.family == "ssm" else None)
    bytes_step = _step_bytes(params, cache, cfg, REC_BATCH)
    state_mb = _state_bytes(cache) / 1e6
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(REC_GEN):
        cache, lg, h = tf.decode_step(params, cache, toks[:, t], cfg,
                                      return_hidden=True)
        outs.append((lg, h))
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / REC_GEN
    for t, ((lg, h), (lg_c, h_c)) in enumerate(zip(outs, res["steps"])):
        if not (bits_equal(lg, lg_c) and bits_equal(h, h_c)):
            raise AssertionError(f"recurrent: {arch}: eager step {t} != "
                                 "the captured step")
    for a, b in zip(_lm_leaves(cache), _lm_leaves(res["cache"])):
        if not bits_equal(a, b):
            raise AssertionError(f"recurrent: {arch}: the eager cache != "
                                 "the captured one")
    del outs
    key = (serve.LM_DECODE, cfg, REC_BATCH, s_max)
    names = tuple(res["cache"])
    step = serve._decode_segment(params, cfg, names)
    leaves = tuple(res["cache"][n] for n in names)
    recorded = dict(prefill_first_ms=res["prefill_ms"],
                    recorded_decode_ms=res["decode_ms_per_token"])
    del res, cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(REC_GEN):
        leaves, _, _ = fam.run(key, step, (leaves, toks[:, t]))
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / REC_GEN
    cache_leaves = _lm_leaves(leaves)
    copy_ms = device_ms(lambda: [x.clone() for x in cache_leaves], calls=3,
                        reps=5)
    bound_ms = bytes_step / PEAK_BYTES_S * 1e3
    row = dict(
        arch=cfg.name, n_params=n_params, bytes_per_step=bytes_step,
        **recorded,
        bound_ms=bound_ms, state_mb=state_mb, peak_gib=peak / 2**30,
        replay_ms=replay_ms, eager_ms=eager_ms,
        prefill_warm_ms=prefill_warm_ms, cache_copy_ms=copy_ms,
        cache_copy_bytes=4 * state_mb * 1e6, slstm_prefill=slstm)
    log(f"[recurrent] (a) {cfg.name} full config ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.family}, vocab {cfg.vocab}, "
        f"{cfg.dtype}): {n_params / 1e9:.3f}B parameters drawn on the card; "
        f"batch {REC_BATCH}, prompt {REC_PROMPT}, {REC_GEN} tokens, "
        f"reranked; the decode state {state_mb:.1f} MB; peak "
        f"memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[recurrent] (a) {cfg.name}: the step alone on the same tokens: "
        f"captured (copy in, replay, clone out) {replay_ms:.3f} ms/token, "
        f"eager {eager_ms:.3f} ms/token; bytes bound {bound_ms:.3f} ms "
        f"({bytes_step / 1e9:.3f} GB a step at {PEAK_BYTES_S / 1e12:.2f} "
        f"TB/s: weights once, the state read and written); eager == "
        f"captured bit for bit in {REC_GEN} steps' logits and hidden "
        f"states and the final cache; prefill warm {prefill_warm_ms:.2f} "
        f"ms; launches {launches}")
    log(f"[recurrent] (a) {cfg.name}: the graph's cache copy: one copy of "
        f"the {state_mb:.1f} MB state {copy_ms:.4f} ms on the device; a "
        f"replay copies it in and clones it out ({4 * state_mb / 1e3:.3f} GB "
        f"of traffic, {2 * copy_ms:.4f} ms, "
        f"{100 * 2 * copy_ms / replay_ms:.1f} % of the captured step)")
    del leaves, cache_leaves, step, fam, params
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's run as a user makes it (nothing recorded)
    run = serve.run_lm(arch, batch=REC_BATCH, prompt_len=REC_PROMPT,
                       gen=REC_GEN, rerank=True)
    row["served"] = {k: run[k] for k in (
        "prefill_ms", "first_step_ms", "decode_ms_per_token", "tok_s")}
    log(f"[recurrent] (a) {cfg.name} served: prefill {run['prefill_ms']:.2f} "
        f"ms (the recording run's, the first: {row['prefill_first_ms']:.2f} "
        f"ms); decode (captured, reranked, with sampling) "
        f"{run['decode_ms_per_token']:.3f} "
        f"ms/token, {run['tok_s']:.1f} tok/s; first step (capture) "
        f"{run['first_step_ms']:.1f} ms; bypass rate {run['bypass_rate']}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _rec_continuation():
    """(b) Published widths cut to one group, float32: prefill(t[:16])
    then decode(t[16]) equals prefill(t[:17]) within 2e-2."""
    from repro_torch.configs import get
    from repro_torch.models import transformer as tf

    rows = []
    for name, depth in REC_DEPTHS:
        cfg = dataclasses.replace(get(name), n_layers=depth,
                                  dtype="float32")
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator("cuda").manual_seed(2),
                                "cuda")
        _lm_offsets(params, torch.Generator("cuda").manual_seed(3))
        batch = _lm_prompt(cfg, 2, 17, 4, "cuda")
        cache, _ = tf.prefill(params, {"tokens": batch["tokens"][:, :16]},
                              cfg)
        _, dec = tf.decode_step(params, cache, batch["tokens"][:, 16], cfg)
        _, full = tf.prefill(params, batch, cfg)
        err = float((dec - full).abs().max())
        ok = torch.allclose(dec, full, rtol=LM_CONT_TOL, atol=LM_CONT_TOL)
        secs = time.perf_counter() - t0
        log(f"[recurrent] (b) {name} at {depth} of {get(name).n_layers} "
            f"layers, d_model {cfg.d_model}, float32: decode after prefill "
            f"vs prefill of the longer prompt, max |diff| {err:.3e} (rule "
            f"rtol = atol = {LM_CONT_TOL}); {secs:.1f} s")
        if not ok:
            raise AssertionError(f"recurrent: {name} decode != prefill "
                                 f"continuation ({err})")
        rows.append(dict(arch=name, layers=depth, max_abs_diff=err))
        del params, cache
        torch.cuda.empty_cache()
    return rows


def _int8_dot_kernel(report):
    """(e) ``int8_dot`` against its plain version (float64 products on the
    card), bit for bit, at the shapes (d) launches and at ragged and
    extreme ones; each timed at (d)'s shapes beside its bytes bound."""
    from repro_torch.configs import get
    from repro_torch.kernels import int8_dot, ref

    name = "int8_dot"
    gen = torch.Generator().manual_seed(23)

    def codes(*shape, extreme=False):
        if extreme:
            x = torch.randint(0, 2, shape, generator=gen) * 254 - 127
        else:
            x = torch.randint(-127, 128, shape, generator=gen)
        return x.to(torch.int8).cuda()

    q, ds = get("qwen3-14b"), get("deepseek-v2-236b")
    B, S = REC_BATCH, INT8_S_MAX
    G = q.n_heads // q.n_kv_heads
    L = ds.mla_cache_dim
    main = {   # (label, fn name, B, Hk, G, S, K, row length)
        "qwen3-14b scores (rows)": ("rows", B, q.n_kv_heads, G, S,
                                    q.head_dim, q.head_dim),
        "qwen3-14b values (cols)": ("cols", B, q.n_kv_heads, G, S,
                                    q.head_dim, q.head_dim),
        "deepseek-v2 scores (rows)": ("rows", B, 1, ds.n_heads, S, L, L),
        "deepseek-v2 values (cols)": ("cols", B, 1, ds.n_heads, S,
                                      ds.kv_lora_rank, L),
    }
    cases = dict(main)
    for fn in ("rows", "cols"):
        cases[f"ragged {fn} K=13 L=17 S=37"] = (fn, 3, 2, 3, 37, 13, 17)
        cases[f"ragged {fn} S=1"] = (fn, 2, 2, 5, 1, 128, 128)
        cases[f"ragged {fn} S=4099"] = (fn, 1, 8, 5, 4099, 128, 128)
        cases[f"extreme {fn} +-127 S=32768"] = (fn, 1, 8, 5, 32768, 128,
                                                128)
    errs, by_shape = {}, {}
    for label, (fn, b, hk, g, s, k, l) in cases.items():
        extreme = label.startswith("extreme")
        c = codes(b, s, hk, l, extreme=extreme)
        a = codes(b, hk, g, k if fn == "rows" else s, extreme=extreme)
        if fn == "rows":
            run = (lambda a=a, c=c: int8_dot.rows(a, c))
            plain = (lambda a=a, c=c: ref.int8_dot_rows_ref(a, c))
            out_n = b * hk * g * s
        else:
            run = (lambda a=a, c=c, k=k: int8_dot.cols(a, c, k))
            plain = (lambda a=a, c=c, k=k: ref.int8_dot_cols_ref(a, c, k))
            out_n = b * hk * g * k
        errs[label] = _check(name, label, _one_launch(name, run), plain())
        if label in main:
            moved = a.numel() + b * s * hk * k + 4 * out_n
            ops = 2 * b * hk * g * s * k
            bms, by = bound(moved, ops / PEAK_INT8_S)
            row = dict(ms=device_ms(run), call_ms=cuda_ms(run),
                       plain_ms=cuda_ms(plain), bound_ms=bms, bound_by=by,
                       bytes=moved)
            by_shape[label] = row
            log(f"[time] {name} {label} [B={b}, Hk={hk}, G={g}, S={s}, "
                f"K={k}, L={l}]: {row['ms']:.4f} ms device (graph of 20), "
                f"{row['call_ms']:.4f} ms a call, plain (float64 einsum) "
                f"{row['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by}); no "
                "PyTorch call computes it (no integer product on CUDA)")
    first = next(iter(main))
    report[name] = dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/int8_dot.cu",
        replaces="src/repro/models/attention.py:178 (jnp.einsum on int8 "
                 "codes; no Pallas kernel)",
        max_abs_err=max(errs.values()), library_ms=None, main_shape=first,
        **{k: by_shape[first][k] for k in ("ms", "call_ms", "plain_ms",
                                            "bound_ms", "bound_by")},
        by_shape=by_shape)
    return by_shape


def _int8_decode(report):
    """(d) int8 decode from ``init_cache`` at qwen3-14b's full config and
    deepseek-v2-236b's published widths cut to 2 layers (bf16 weights):
    every step's softmax within 0.05 of the bf16 cache's decode (the
    reference's criterion), the logits' largest difference reported; the
    int8 steps replayed from a CUDA graph bit-equal to eager. Launches of
    ``int8_dot`` counted from 0 around the eager int8 decode: the main
    path's run."""
    import gc

    from repro_torch.configs import get
    from repro_torch.core import capture
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    rows, total = [], 0
    for name, depth in INT8_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get(name) if depth is None else dataclasses.replace(
            get(name), n_layers=depth)
        cfgq = dataclasses.replace(cfg, serve_quant="int8")
        t0 = time.perf_counter()
        params = tf.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                "cuda")
        toks = _lm_prompt(cfg, REC_BATCH, INT8_T, 9, "cuda")["tokens"]
        cb = tf.init_cache(cfg, REC_BATCH, INT8_S_MAX, "cuda")
        logits_b = []
        for t in range(INT8_T):
            cb, lb = tf.decode_step(params, cb, toks[:, t], cfg)
            logits_b.append(lb)
        del cb
        cq = tf.init_cache(cfgq, REC_BATCH, INT8_S_MAX, "cuda")
        fresh = capture.tree_map(torch.clone, cq)
        torch.cuda.synchronize()
        build.reset_launches()
        t1 = time.perf_counter()
        logits_q = []
        for t in range(INT8_T):
            cq, lq = tf.decode_step(params, cq, toks[:, t], cfgq)
            logits_q.append(lq)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t1) * 1e3 / INT8_T
        n = build.LAUNCHES["int8_dot"]
        want = 2 * cfg.n_layers * INT8_T
        if n != want:
            raise AssertionError(f"int8: {name}: int8_dot launched {n} "
                                 f"times, {want} expected")
        total += n
        sm = max(float((torch.softmax(a, -1) - torch.softmax(b, -1)).abs()
                       .max()) for a, b in zip(logits_b, logits_q))
        dl = max(float((a - b).abs().max())
                 for a, b in zip(logits_b, logits_q))
        scale = max(float(a.abs().max()) for a in logits_b)
        if not sm < INT8_SOFTMAX_TOL:
            raise AssertionError(f"int8: {name}: max |softmax diff| {sm}")
        # the same steps through a CUDA graph, from a fresh int8 cache
        names = tuple(fresh)
        step = serve._decode_segment(params, cfgq, names)
        fam = capture.GraphFamily()
        leaves = tuple(fresh[k] for k in names)
        key = (serve.LM_DECODE, cfgq, REC_BATCH, INT8_S_MAX)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(INT8_T):
            leaves, lg, _ = fam.run(key, step, (leaves, toks[:, t]))
            if t == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            if not bits_equal(lg, logits_q[t]):
                raise AssertionError(f"int8: {name}: captured step {t} != "
                                     "eager")
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t1) * 1e3 / (INT8_T - 1)
        for a, b in zip(_lm_leaves(leaves), _lm_leaves(
                tuple(cq[k] for k in names))):
            if not bits_equal(a, b):
                raise AssertionError(f"int8: {name}: the captured cache != "
                                     "the eager one")
        secs = time.perf_counter() - t0
        label = cfg.name + (f" at {depth} of {get(name).n_layers} layers"
                            if depth else " full config")
        log(f"[int8] (d) {label} (bf16 weights, batch {REC_BATCH}, "
            f"{INT8_T} tokens from init_cache, S_max {INT8_S_MAX}): max "
            f"|softmax(bf16 cache) - softmax(int8 cache)| {sm:.3e} (rule < "
            f"{INT8_SOFTMAX_TOL}); max |logit diff| {dl:.4f} at a logit "
            f"scale of {scale:.3f}; int8_dot launched {n} times ({want} "
            f"expected); eager {eager_ms:.3f} ms/token, captured "
            f"{replay_ms:.3f} ms/token (copy in, replay, clone out), "
            f"captured == eager bit for bit in every step and the cache; "
            f"{secs:.1f} s")
        rows.append(dict(arch=cfg.name, layers=cfg.n_layers,
                         max_softmax_diff=sm, max_logit_diff=dl,
                         logit_scale=scale, int8_dot_launches=n,
                         eager_ms=eager_ms, replay_ms=replay_ms))
        del params, cq, fresh, leaves, step, fam, logits_b, logits_q
    report["int8_dot"]["launches"] = total
    return rows


def _rec_cli():
    """(f) The launcher as a user runs it, in a subprocess, at
    xlstm-1.3b's full config."""
    import os
    import subprocess

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "xlstm-1.3b", "--batch", "2", "--prompt-len", "16", "--gen", "8"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(
                             ROOT / "src")))
    secs = time.perf_counter() - t0
    if out.returncode != 0 or "generated shape (2, 8)" not in out.stdout:
        raise AssertionError(f"recurrent: the launcher failed "
                             f"({out.returncode}): {out.stdout[-2000:]} "
                             f"{out.stderr[-2000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("[serve]"):
            log(f"[recurrent] (f) {line}")
    log(f"[recurrent] (f) python -m repro_torch.launch.serve --arch "
        f"xlstm-1.3b --batch 2 --prompt-len 16 --gen 8: exit 0, "
        f"{secs:.1f} s")
    return dict(seconds=secs)


def phase_recurrent(report):
    """Phase 16 (after 15, before 10; TF32 and reduced-precision
    reductions off as in phase 15): (e) ``int8_dot`` against its plain
    version and timed; (d) int8 decode from ``init_cache``; (a) both
    recurrent families at their full configs through ``run_lm``; (b) their
    published widths cut in depth, decode == prefill continuation; (c)
    their smoke configs, card == CPU; (f) the CLI at xlstm-1.3b's full
    config. The launches of ``int8_dot`` (d) and of the reranker's two
    kernels (a) must be above zero."""
    row = {}
    with _lm_flags() as flags:
        row["flags"] = flags
        row["int8_dot"] = _int8_dot_kernel(report)
        row["int8_decode"] = _int8_decode(report)
        row["serve"] = [_rec_serving(arch, report) for arch in REC_ARCHS]
        row["continuation"] = _rec_continuation()
        row["card_vs_cpu"] = [
            r for dtype in (torch.float32, torch.bfloat16)
            for r in _with_scores(dtype, REC_ARCHS, REC_SMOKE_PROMPT)]
    row["cli"] = _rec_cli()
    for name in ("int8_dot", "sign_project_pack", "packed_hamming_batched"):
        n = report[name].get("launches") if name == "int8_dot" else sum(
            report[name].get("phase16_launches", {}).values())
        if not n:
            raise AssertionError(f"phase 16: {name} never launched")
    return row


def _with_scores(dtype, names, S):
    with _lm_scores(dtype):
        return _lm_card_vs_cpu_at(dtype, names, S, tag="(c) [recurrent]")


# phase 17: LM training. (a) deepseek-7b (src/repro/configs/registry.py, the
# training launcher's default --arch) at its published widths, depth cut
# from 30 to 4 layers (AdamW's state for 30 does not fit in 80 GB)
TRAIN_ARCH, TRAIN_LAYERS = "deepseek-7b", 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20
TRAIN_OPT = dict(lr=3e-4, warmup_steps=4, total_steps=TRAIN_STEPS)
# (b): the same widths cut to one layer, float32, 1 x 128 tokens
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 1, 128
# (c): every family's smoke config (MoE with MTP: deepseek-v3)
TRAIN_SMOKE = ("gemma-7b", "deepseek-7b", "musicgen-large",
               "llama-3.2-vision-90b", "deepseek-v3-671b",
               "recurrentgemma-2b", "xlstm-1.3b")
TRAIN_SMOKE_B, TRAIN_SMOKE_S = 2, 64
# card against CPU, float32 models: with float32 score products, the
# loss rtol 1e-5 and every gradient leaf within 1e-4 of its largest
# magnitude (tests/test_torch_train.py's rule against the reference); with
# the model's bfloat16 score products, whose backward rounds each score
# gradient to bfloat16 (where the card's and the CPU's float32 inputs
# round apart, it moves by an ulp, 2^-8), the loss rtol 1e-5 and every
# leaf within two bfloat16 ulps, 2^-7, of its largest magnitude (an
# H100 run measured 1.9e-3 in (b) and 2.3e-3 at gemma-7b's smoke ln1 in
# (c))
TRAIN_LOSS_RTOL = 1e-5
TRAIN_F32_OF_MAX = 1e-4
TRAIN_BF16_SCORES_OF_MAX = 2.0 ** -7
# bfloat16 models, card against CPU (two eager runs whose GEMMs sum in
# different orders and round each output to bfloat16): the loss rtol 5e-4,
# every gradient leaf within 4e-2 of its norm (an H100 run measured a
# worst of 4.8e-5 in the loss, at deepseek-v3's smoke, and 1.2e-2 in a
# leaf, at xlstm's; the rules are about 10x and 3x those)
TRAIN_BF16_LOSS_RTOL = 5e-4
TRAIN_BF16_OF_NORM = 4e-2
# (d): the supervisor at gemma-7b's smoke config, a fault at step 23
TRAIN_SUP_ARCH, TRAIN_SUP_STEPS, TRAIN_SUP_FAULT = "gemma-7b", 40, 23
TRAIN_SUP_EVERY = 10


def _flat_grads_close(label, got: dict, want: dict, of_max=None,
                      of_norm=None) -> float:
    """Every leaf of ``got`` (on the card) against ``want`` (the CPU's):
    |got - want| <= of_max * max|want|, or ||got - want|| <= of_norm *
    ||want||. Returns the worst ratio."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].detach().cpu().float()
        w = w.detach().float()
        if of_max is not None:
            scale, err, bound = float(w.abs().max()), \
                float((g - w).abs().max()), of_max
        else:
            scale, err, bound = float(w.norm()), float((g - w).norm()), \
                of_norm
        ratio = err / scale if scale else err
        worst = max(worst, ratio)
        if not err <= bound * scale:
            raise AssertionError(f"train: {label} {k}: {err:.3e} against "
                                 f"{bound:g} x {scale:.3e}")
    return worst


def _train_flops(cfg, params) -> tuple[float, int]:
    """(model FLOPs of one step, N): 6 N tokens for the N parameters that
    enter a product (all but the input embedding, which is gathered) plus
    the attention products as the port computes them: every query chunk
    against all S keys (4 B H S^2 dh a layer forward, 3x with the
    backward)."""
    n = sum(p.numel() for k, p in params.items() if k != "embed")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 12 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * \
        cfg.head_dim * cfg.n_layers
    return 6.0 * n * tokens + attn, n


def _train_full(flags):
    """(a) The train step at deepseek-7b's widths, 4 layers, bf16,
    remat "nothing", 4 x 2048 tokens of TokenStream for 20 steps."""
    import gc

    from repro_torch.configs import get
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat_policy="nothing")
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_train_state(cfg, seed=0, device="cuda")
    params, opt = state["params"], state["opt"]
    del state
    flops, n_mm = _train_flops(cfg, params)
    n_all = sum(p.numel() for p in params.values())
    step = steps.make_train_step(cfg, adamw.OptimConfig(**TRAIN_OPT),
                                 device="cuda")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    host_ms, step_ms, losses = [], [], []
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = stream.batch_at(i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, opt, metrics = step(params, opt, batch)
        ev[1].record()
        step_ms.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_loop
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: (a) a loss is not finite: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"train: (a) the loss did not fall over "
                             f"{TRAIN_STEPS} steps: {losses}")
    busy = _train_profile(step, params, opt, stream.batch_at(TRAIN_STEPS))
    busy["split_ms"] = _train_split(cfg, params, opt,
                                    stream.batch_at(TRAIN_STEPS))
    warm = spread(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = flops / (warm["median"] * 1e-3) / PEAK_BF16_S
    card = _smi()
    log(f"[train] (a) {TRAIN_ARCH} at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), {TRAIN_LAYERS} of 30 layers, bf16, remat "
        f"\"nothing\", {n_all / 1e9:.3f}B parameters ({n_mm / 1e9:.3f}B in "
        f"products), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} "
        f"steps, {flags}; {card}")
    log(f"[train] (a) ms/step {fmt_spread(warm)} (steps 2-{TRAIN_STEPS}; "
        f"the first {step_ms[0]:.1f} ms), {tokens / warm['median'] * 1e3:.0f}"
        f" tokens/s ({TRAIN_STEPS * tokens / wall:.0f} over the loop's "
        f"{wall:.2f} s wall); model FLOPs {flops / 1e12:.2f} T a step, "
        f"bound {flops / PEAK_BF16_S * 1e3:.2f} ms at 989 TFLOP/s bf16, "
        f"MFU {mfu * 100:.1f} %; peak memory_allocated {peak / 2**30:.2f} "
        f"GiB; batch_at on the host {fmt_spread(spread(host_ms))}; loss "
        f"first 5 {first:.4f}, last 5 {last:.4f}")
    row = dict(arch=TRAIN_ARCH, layers=TRAIN_LAYERS, params=n_all,
               params_in_products=n_mm, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, ms_per_step=warm, first_step_ms=step_ms[0],
               tokens_per_s=tokens / warm["median"] * 1e3,
               loop_tokens_per_s=TRAIN_STEPS * tokens / wall,
               model_tflop=flops / 1e12,
               bound_ms=flops / PEAK_BF16_S * 1e3, mfu=mfu,
               peak_allocated_gib=peak / 2**30,
               batch_at_ms=spread(host_ms), loss_first5=first,
               loss_last5=last, losses=losses, profile=busy, card=card)
    del params, opt, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


# cuBLAS's GEMM kernels on Hopper ("nvjet_*", "sm90_xmma_*", cutlass)
_GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def _train_profile(step, params, opt, batch) -> dict:
    """One more step under torch.profiler: its wall ms, the device's busy
    ms (the kernels' summed device time), the share of the GEMM kernels
    and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del out
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us and getattr(evt, "device_type", None) is not None and \
                "CUDA" in str(evt.device_type):
            kernels.append((us / 1e3, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    gemm = sum(k[0] for k in kernels
               if any(n in k[1].lower() for n in _GEMM_NAMES))
    top = [dict(name=n[:80], ms=ms, calls=c) for ms, n, c in kernels[:8]]
    log(f"[train] (a) one step under torch.profiler: wall {wall:.1f} ms, "
        f"device busy {busy:.1f} ms ({busy / wall * 100:.1f} %), GEMM "
        f"kernels {gemm:.1f} ms ({gemm / max(busy, 1e-9) * 100:.1f} % of "
        f"busy), {sum(k[2] for k in kernels)} kernel launches")
    for t in top:
        log(f"[train] (a)   {t['ms']:9.2f} ms  {t['calls']:5d} x  "
            f"{t['name']}")
    return dict(wall_ms=wall, busy_ms=busy, gemm_ms=gemm,
                launches=sum(k[2] for k in kernels), top=top)


def _train_split(cfg, params, opt, batch) -> dict:
    """The step's two halves timed apart with CUDA events (median of 3):
    ``loss_and_grads`` (forward, recomputation, backward) and AdamW's
    ``apply_updates``."""
    from repro_torch.data.tokens import to_device
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    batch = to_device(batch, "cuda")
    ocfg = adamw.OptimConfig(**TRAIN_OPT)
    decay = steps.decayed(params)
    grads = steps.loss_and_grads(cfg, params, batch)[2]
    fwd = statistics.median(cuda_times(
        lambda: steps.loss_and_grads(cfg, params, batch), reps=3,
        warmup=0))
    opt_ms = statistics.median(cuda_times(
        lambda: adamw.apply_updates(params, grads, opt, ocfg, decay),
        reps=3, warmup=1))
    log(f"[train] (a) the step's halves (CUDA events, median of 3): "
        f"forward and backward {fwd:.1f} ms, AdamW {opt_ms:.1f} ms")
    return dict(forward_backward=fwd, adamw=opt_ms)


def _smi() -> str:
    from repro_torch.device import smi

    return smi("name,power.limit")


def _train_card_vs_cpu_full():
    """(b) deepseek-7b's widths cut to one layer, float32, TF32 off,
    1 x 128 tokens: the card's loss, grad norm and every gradient leaf
    against the port's CPU run of the same step, with the score products
    in float32 and as the model computes them (bfloat16)."""
    import gc

    from repro_torch.configs import get
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=1, dtype="float32")
    card = tf.init_params(cfg, torch.Generator("cuda").manual_seed(11),
                          "cuda")
    _lm_offsets(card, torch.Generator("cuda").manual_seed(12))
    p_card = dict(card.state_dict())
    del card
    p_cpu = {k: v.cpu() for k, v in p_card.items()}
    batch = TokenStream(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ,
                        seed=1).batch_at(0)
    rows = []
    for scores, of_max in ((torch.float32, TRAIN_F32_OF_MAX),
                           (torch.bfloat16, TRAIN_BF16_SCORES_OF_MAX)):
        with _lm_scores(scores):
            t0 = time.perf_counter()
            l_card, _, g_card = steps.loss_and_grads(
                cfg, p_card, {k: torch.from_numpy(v).cuda() for k, v in
                              batch.items()})
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            l_cpu, _, g_cpu = steps.loss_and_grads(
                cfg, p_cpu, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
            t_cpu = time.perf_counter() - t0
        sc = str(scores).removeprefix("torch.")
        gn_card = float(adamw.global_norm(g_card))
        gn_cpu = float(adamw.global_norm(g_cpu))
        if not math.isclose(float(l_card), float(l_cpu),
                            rel_tol=TRAIN_LOSS_RTOL):
            raise AssertionError(f"train: (b) {sc} scores: loss "
                                 f"{float(l_card)} on the card, "
                                 f"{float(l_cpu)} on the CPU")
        if not math.isclose(gn_card, gn_cpu, rel_tol=of_max):
            raise AssertionError(f"train: (b) {sc} scores: grad norm "
                                 f"{gn_card} on the card, {gn_cpu} on the "
                                 "CPU")
        worst = _flat_grads_close(f"(b) {sc} scores", g_card, g_cpu,
                                  of_max=of_max)
        log(f"[train] (b) {TRAIN_ARCH} widths, 1 layer, float32, {sc} "
            f"scores, TF32 off, {TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens: "
            f"loss {float(l_card):.6f} card / {float(l_cpu):.6f} CPU, grad "
            f"norm {gn_card:.6f} / {gn_cpu:.6f} (rule {of_max:g}), every one "
            f"of {len(g_cpu)} gradient leaves within {of_max:g} of its "
            f"largest magnitude (worst {worst:.3e}); forward and backward "
            f"{t_card:.2f} s on the card, {t_cpu:.2f} s on the CPU")
        rows.append(dict(scores=sc, loss_card=float(l_card),
                         loss_cpu=float(l_cpu), grad_norm_card=gn_card,
                         grad_norm_cpu=gn_cpu, worst_of_max=worst,
                         rule=of_max))
        del g_card, g_cpu
    del p_card, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _train_smoke_pair(name, dtype):
    """(loss, metrics, grads) on the card and on the CPU for one smoke
    config from one draw (every vector leaf drawn)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get_smoke(name), dtype=dtype)
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(21), "cpu")
    _lm_offsets(cpu, torch.Generator().manual_seed(22))
    p_cpu = dict(cpu.state_dict())
    p_card = {k: v.cuda() for k, v in p_cpu.items()}
    batch = TokenStream(cfg, TRAIN_SMOKE_B, TRAIN_SMOKE_S,
                        seed=3).batch_at(0)
    on_card = steps.loss_and_grads(cfg, p_card, {
        k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    on_cpu = steps.loss_and_grads(cfg, p_cpu, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    return on_card, on_cpu


def _train_smoke_card_vs_cpu():
    """(c) The seven smoke configs, card against the port's CPU run of
    forward_train and its gradients: float32 (score products in float32,
    then as the model computes them) and bfloat16."""
    rows = []
    cases = [("float32", torch.float32), ("float32", torch.bfloat16),
             ("bfloat16", torch.bfloat16)]
    for dtype, scores in cases:
        for name in TRAIN_SMOKE:
            with _lm_scores(scores):
                (lg, mg, gg), (lc, mc, gc_) = _train_smoke_pair(name, dtype)
            if dtype == "bfloat16":
                rtol, kw = TRAIN_BF16_LOSS_RTOL, dict(
                    of_norm=TRAIN_BF16_OF_NORM)
            elif scores == torch.float32:
                rtol, kw = TRAIN_LOSS_RTOL, dict(of_max=TRAIN_F32_OF_MAX)
            else:
                rtol, kw = TRAIN_LOSS_RTOL, dict(
                    of_max=TRAIN_BF16_SCORES_OF_MAX)
            for k in mc:
                if not math.isclose(float(mg[k]), float(mc[k]),
                                    rel_tol=rtol, abs_tol=1e-7):
                    raise AssertionError(
                        f"train: (c) {name} {dtype} {k}: {float(mg[k])} on "
                        f"the card, {float(mc[k])} on the CPU")
            label = f"(c) {name} {dtype}"
            worst = _flat_grads_close(label, gg, gc_, **kw)
            sc = str(scores).removeprefix("torch.")
            rel = abs(float(lg) - float(lc)) / abs(float(lc))
            rule = (f"{kw.get('of_max')} of each leaf's maximum"
                    if "of_max" in kw else f"{kw['of_norm']} of its norm")
            log(f"[train] (c) {name} smoke, {dtype}, {sc} scores: loss "
                f"{float(lg):.6f} card / {float(lc):.6f} CPU (rel "
                f"{rel:.2e}, rule {rtol:g}); every gradient leaf within "
                f"{rule} (worst {worst:.3e})")
            rows.append(dict(arch=name, dtype=dtype, scores=sc,
                             loss_rel=rel, worst=worst))
    return rows


def _train_supervised():
    """(d) TrainSupervisor at gemma-7b's smoke config on the card under
    torch.use_deterministic_algorithms: a fault at step 23 ends in the
    clean run's state."""
    import os
    import tempfile
    import warnings

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.runtime.fault import SupervisorConfig, TrainSupervisor

    cfg = get_smoke(TRAIN_SUP_ARCH)
    env_was = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    finals, secs = [], []
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            for fault in (None, TRAIN_SUP_FAULT):
                step = steps.make_train_step(
                    cfg, adamw.OptimConfig(lr=3e-4, warmup_steps=8,
                                           total_steps=TRAIN_SUP_STEPS),
                    device="cuda")
                stream = TokenStream(cfg, 8, 64)

                def step_fn(state, batch):
                    p, o, _ = step(state["params"], state["opt"], batch)
                    return {"params": p, "opt": o}

                sup = TrainSupervisor(
                    step_fn, CheckpointManager(f"{tmp}/{fault}"),
                    SupervisorConfig(ckpt_every=TRAIN_SUP_EVERY))
                t0 = time.perf_counter()
                state, end = sup.run(
                    steps.init_train_state(cfg, seed=0, device="cuda"),
                    stream.stream, TRAIN_SUP_STEPS, fault_at=fault,
                    device="cuda")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                if end != TRAIN_SUP_STEPS or sup.restarts != (fault
                                                               is not None):
                    raise AssertionError(f"train: (d) ended at {end} after "
                                         f"{sup.restarts} restarts")
                finals.append(state)
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(was)
        if env_was is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_was
    clean, faulty = ({**s["params"], "step": s["opt"]["step"],
                      **{f"{m}.{k}": v for m in ("mu", "nu")
                         for k, v in s["opt"][m].items()}} for s in finals)
    if nondet:
        # a tolerance in place of bit-equality, naming the ops
        worst = _flat_grads_close("(d)", faulty, clean, of_max=1e-6)
        verdict = (f"within 1e-6 of each leaf's maximum (worst "
                   f"{worst:.3e}): no deterministic CUDA version of "
                   f"{nondet}")
    else:
        diff = [k for k in clean if not bits_equal(clean[k], faulty[k])]
        if diff:
            raise AssertionError(f"train: (d) the faulted run differs in "
                                 f"{diff[:5]}")
        verdict = "bit-equal"
    log(f"[train] (d) TrainSupervisor, {TRAIN_SUP_ARCH} smoke on the card, "
        f"deterministic algorithms, CUBLAS_WORKSPACE_CONFIG=:4096:8: "
        f"{TRAIN_SUP_STEPS} steps clean ({secs[0]:.2f} s) and with a fault "
        f"at step {TRAIN_SUP_FAULT} restored from step 20 ({secs[1]:.2f} "
        f"s): parameters and moments {verdict}")
    return dict(verdict=verdict, nondeterministic=nondet, seconds=secs)


def _train_cli():
    """(d) The training launcher as a user runs it, in a subprocess, at
    gemma-7b's smoke config on the card."""
    import os
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_SUP_ARCH, "--smoke", "--steps", "40", "--batch", "8",
               "--seq", "64", "--ckpt", tmp]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ, PYTHONPATH=str(
                                 ROOT / "src")))
    secs = time.perf_counter() - t0
    if out.returncode != 0 or "loss improved" not in out.stdout:
        raise AssertionError(f"train: the launcher failed ({out.returncode})"
                             f": {out.stdout[-2000:]} {out.stderr[-2000:]}")
    for line in out.stdout.splitlines():
        if line.startswith("[train] arch=") or "improved" in line:
            log(f"[train] (d) {line}")
    log(f"[train] (d) python -m repro_torch.launch.train --arch "
        f"{TRAIN_SUP_ARCH} --smoke --steps 40 --batch 8 --seq 64: exit 0, "
        f"{secs:.1f} s")
    return dict(seconds=secs)


def phase_train(report):
    """Phase 17 (after 16, before 10; TF32 and reduced-precision
    reductions off as in phase 15): (a) the full-width train step; (b) one
    layer of it in float32 against the CPU; (c) the smoke configs against
    the CPU; (d) the supervisor with a fault, and the CLI. Training runs
    none of the hand-written kernels: their launches are counted from 0
    around the phase and recorded (``phase17_launches``)."""
    from repro_torch.kernels import build

    build.reset_launches()
    row = {}
    with _lm_flags() as flags:
        row["flags"] = flags
        row["full"] = _train_full(flags)
        row["card_vs_cpu"] = _train_card_vs_cpu_full()
        row["smoke"] = _train_smoke_card_vs_cpu()
        row["supervised"] = _train_supervised()
    row["cli"] = _train_cli()
    launches = dict(build.LAUNCHES)
    for name, r in report.items():
        r["phase17_launches"] = launches.get(name, 0)
    log(f"[train] launches of the hand-written kernels in phase 17: "
        f"{launches} (training runs none of them)")
    return row


# phase 18: the mesh layer on one card (a one-rank NCCL group)
MESH_STEPS = 3
# deepseek-v2-236b's MoE widths for moe_ffn_ep (bf16 experts: 7.5 GB)
EP_ARCH, EP_BATCH, EP_SEQ = "deepseek-v2-236b", 4, 2048
EP_OF_MAX = 2.0 ** -7
# moe_ffn_ep's placements: the expert stacks and the shared experts'
# columns over 'model', the router whole
EP_SPECS = {"router": (), "w_gate": ("model", None, None),
            "w_up": ("model", None, None), "w_down": ("model", None, None),
            "shared_gate": (None, "model"), "shared_up": (None, "model"),
            "shared_down": ("model", None)}
PIPE_LAYERS, PIPE_D, PIPE_MICRO, PIPE_MB = 4, 1024, 4, 8
DRYRUN_ARCH, DRYRUN_SHAPE = "deepseek-7b", "train_4k"
DRYRUN_FLOPS_RATIO = 2.0    # (d): the most FLOPs over model_flops
# (f): a 2x2 ("data", "model") gloo mesh of 4 CPU ranks under the card
# host's torch; the smoke configs whose decode attention DTensor could not
# shard there before the decode cores ran through spmd.per_head; decode
# within 1e-4 of each tensor's largest magnitude (tests/test_torch_
# mesh_run.py's rule, float32 with float32 score products)
MESH_DECODE_ARCHS = ("musicgen-large", "llama-3.2-vision-90b")
MESH_DECODE_TOL = 1e-4
MESH_DECODE_LIMIT_S = 45.0
MESH_DECODE_B, MESH_DECODE_S = 4, 16


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_train(mesh) -> dict:
    """(a) Phase 17's cell (deepseek-7b's widths, 4 of 30 layers, bf16,
    4 x 2048 tokens) for MESH_STEPS steps: the plain step, then the step
    on the 1x1 mesh with parameters, AdamW state and batch placed by the
    specs, both from seed 0; losses and parameters bit-equal."""
    import gc

    from repro_torch.configs import get
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat_policy="nothing")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    ocfg = adamw.OptimConfig(**TRAIN_OPT)
    runs = {}
    for label in ("plain", "mesh"):
        state = steps.init_train_state(cfg, seed=0, device="cuda")
        params, opt = state["params"], state["opt"]
        del state
        if label == "mesh":
            params = shd.distribute(params,
                                    shd.params_sharding(params, mesh))
            opt = shd.distribute(opt, shd.params_sharding(opt, mesh))
        step = steps.make_train_step(cfg, ocfg, device="cuda",
                                     mesh=mesh if label == "mesh" else None)
        ms, losses = [], []
        for i in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, stream.batch_at(i))
            loss = metrics["loss"]
            loss = loss.full_tensor() if hasattr(loss, "full_tensor") \
                else loss
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        host = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                .to("cpu") for k, v in params.items()}
        runs[label] = dict(ms=ms, losses=losses, params=host)
        del params, opt, metrics, step
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs["plain"], runs["mesh"]
    if a["losses"] != b["losses"]:
        raise AssertionError(f"mesh (a): losses {b['losses']} on the 1x1 "
                             f"mesh, {a['losses']} plain")
    diff = [k for k in a["params"] if not torch.equal(a["params"][k],
                                                      b["params"][k])]
    if diff:
        raise AssertionError(f"mesh (a): parameters differ after "
                             f"{MESH_STEPS} steps: {diff[:5]}")
    row = dict(arch=TRAIN_ARCH, layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=MESH_STEPS, losses=a["losses"],
               plain_ms=a["ms"], mesh_ms=b["ms"],
               plain_ms_after_first=statistics.median(a["ms"][1:]),
               mesh_ms_after_first=statistics.median(b["ms"][1:]))
    log(f"[mesh] (a) {TRAIN_ARCH} {TRAIN_LAYERS} layers, bf16, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, {MESH_STEPS} steps on a 1x1 "
        f"(data, model) mesh of one NCCL rank: losses and parameters "
        f"bit-equal to the plain step ({a['losses']}); ms/step plain "
        f"{[round(x, 2) for x in a['ms']]}, mesh "
        f"{[round(x, 2) for x in b['ms']]} (DTensor's host overhead; the "
        f"first step propagates every op's sharding once)")
    return row


def _grads_of(fn, leaves: dict):
    for t in leaves.values():
        t.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = fn()
    (y.float().square().mean() + aux).backward()
    torch.cuda.synchronize()
    return y, aux, (time.perf_counter() - t0) * 1e3


def _mesh_ep(mesh) -> dict:
    """(b) moe_ffn_ep on the 1x1 mesh at deepseek-v2-236b's MoE widths
    against moe_ffn, forward and gradients of mean(y^2) + aux."""
    from types import SimpleNamespace

    from repro_torch.configs import get
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd

    cfg = get(EP_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe_params(cfg, torch.bfloat16, generator=gen,
                            device="cuda")
    flat = {k: v.detach().requires_grad_(True)
            for k, v in p.state_dict().items()}
    x = torch.randn(EP_BATCH, EP_SEQ, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_(True)
    expert_gb = sum(flat[k].numel() * 2 for k in ("w_gate", "w_up",
                                                   "w_down")) / 1e9
    out = {}
    ms = {}
    for label in ("plain", "plain", "ep", "ep"):
        if label == "plain":
            y, aux, t = _grads_of(lambda: moe.moe_ffn(
                SimpleNamespace(**flat), x, cfg), {**flat, "x": x})
            got = {k: v.grad.clone() for k, v in flat.items()}
            got["x"] = x.grad.clone()
        else:
            from torch.distributed.tensor import distribute_tensor
            dp = {k: distribute_tensor(v.detach(), mesh,
                                       shd.placements(EP_SPECS[k], mesh))
                  .requires_grad_(True) for k, v in flat.items()}
            xs = distribute_tensor(x.detach(), mesh, shd.placements(
                ("data", None, None), mesh)).requires_grad_(True)
            ep_cfg = dataclasses.replace(cfg, moe_groups=1)
            with spmd.mesh_mode():
                y, aux, t = _grads_of(lambda: moe.moe_ffn(
                    SimpleNamespace(**dp), xs, ep_cfg, mesh=mesh),
                    {**dp, "x": xs})
            y, aux = y.full_tensor(), aux.full_tensor()
            got = {k: v.grad.full_tensor() for k, v in dp.items()}
            got["x"] = xs.grad.full_tensor()
        ms.setdefault(label, []).append(t)
        out[label] = (y.detach(), aux.detach(), got)
    (y0, a0, g0), (y1, a1, g1) = out["plain"], out["ep"]
    y_err = (y1.float() - y0.float()).abs().max().item() / max(
        y0.float().abs().max().item(), 1e-30)
    g_err = {k: (g1[k].float() - g0[k].float()).abs().max().item()
             / max(g0[k].float().abs().max().item(), 1e-30) for k in g0}
    exact = y_err == 0 and a1.item() == a0.item() and \
        max(g_err.values()) == 0
    # rule: within a bfloat16 ulp (2^-7) of each tensor's largest
    # magnitude; on one rank the EP routing is the global one, so equal
    # values are expected
    if y_err > EP_OF_MAX or abs(a1.item() - a0.item()) > EP_OF_MAX * abs(
            a0.item()) or max(g_err.values()) > EP_OF_MAX:
        raise AssertionError(f"mesh (b): moe_ffn_ep on one rank differs "
                             f"from moe_ffn: y {y_err}, aux {a1.item()} vs "
                             f"{a0.item()}, gradients {g_err}")
    row = dict(arch=EP_ARCH, d_model=cfg.d_model, experts=cfg.n_experts,
               moe_d_ff=cfg.moe_d_ff, top_k=cfg.moe_top_k,
               shared=cfg.n_shared_experts, tokens=EP_BATCH * EP_SEQ,
               expert_gb=expert_gb, plain_ms=ms["plain"], ep_ms=ms["ep"],
               bit_equal=exact, y_of_max=y_err,
               grad_of_max=max(g_err.values()))
    log(f"[mesh] (b) moe_ffn_ep on the 1x1 mesh at {EP_ARCH}'s MoE widths "
        f"(d_model {cfg.d_model}, {cfg.n_experts} experts, moe_d_ff "
        f"{cfg.moe_d_ff}, top-{cfg.moe_top_k}, {cfg.n_shared_experts} "
        f"shared; {expert_gb:.2f} GB of bf16 experts), {EP_BATCH} x "
        f"{EP_SEQ} tokens: against moe_ffn, output {y_err:.3g} and "
        f"gradients {max(g_err.values()):.3g} of their largest (bit-equal: "
        f"{exact}); forward + backward ms plain "
        f"{[round(v, 2) for v in ms['plain']]}, ep "
        f"{[round(v, 2) for v in ms['ep']]}")
    del out, flat, x, p
    torch.cuda.empty_cache()
    return row


def _pipe_inputs():
    """The pipeline checks' layers W [PIPE_LAYERS, PIPE_D, PIPE_D] and
    microbatches [PIPE_MICRO, PIPE_MB, PIPE_D], from seed 0 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    W = (torch.randn(PIPE_LAYERS, PIPE_D, PIPE_D, generator=gen,
                     device="cuda") * PIPE_D ** -0.5)
    xs = torch.randn(PIPE_MICRO, PIPE_MB, PIPE_D, generator=gen,
                     device="cuda")
    return W, xs


def _pipe_stage(params, x):
    """A stage: tanh(x @ W) for each of its layers."""
    for i in range(params.shape[0]):
        x = torch.tanh(x @ params[i])
    return x


def _mesh_pipeline() -> dict:
    """(c) pipeline_apply over a pod axis of one rank against the
    sequential model: forward and gradients."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                        split_stages)

    mesh = make_host_mesh(1, 1, pod=1, device="cuda")
    W, xs = _pipe_inputs()
    Wp = W.clone().requires_grad_(True)
    out = pipeline_apply(_pipe_stage, split_stages(Wp, 1), xs, mesh, "pod")
    torch.sum(out ** 2).backward()
    Ws = W.clone().requires_grad_(True)
    seq = torch.stack([_pipe_stage(Ws, xs[i]) for i in range(PIPE_MICRO)])
    torch.sum(seq ** 2).backward()
    f_err = (out - seq).abs().max().item()
    g_err = (Wp.grad - Ws.grad).abs().max().item()
    if f_err > 1e-5 or g_err > 1e-4 * Ws.grad.abs().max().item():
        raise AssertionError(f"mesh (c): pipeline {f_err} (forward), "
                             f"{g_err} (gradients) from the sequential model")
    log(f"[mesh] (c) pipeline_apply over a pod axis of one rank, "
        f"{PIPE_LAYERS} layers of width {PIPE_D}, {PIPE_MICRO} microbatches "
        f"of {PIPE_MB}: forward {f_err:.3g}, gradients {g_err:.3g} from the "
        f"sequential model")
    return dict(forward_err=f_err, grad_err=g_err)


def _start_dryrun():
    """(d) The dry-run of one production cell, started in a subprocess (a
    fake group of 256 ranks, one process of one thread, the CPU only)
    after (a), while (b), (c) and (e) use the card."""
    import subprocess

    out = ROOT / "experiments" / "dryrun_torch"   # the dry-run's own
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    log_f = open(out / "dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--out-dir", str(out),
         "--save-ops"], env=env, stdout=log_f, stderr=subprocess.STDOUT,
        cwd=ROOT)
    return proc, log_f, out, env, time.perf_counter()


def _mesh_dryrun(started) -> dict:
    """(d) The dry-run's record and profile_cell's top 10 from its saved
    ops."""
    import subprocess

    proc, log_f, out, env, t0 = started
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_f.close()
    wall = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"mesh (d): the dry-run failed: "
                             f"{(out / 'dryrun.log').read_text()[-2000:]}")
    cell = f"{DRYRUN_ARCH}__{DRYRUN_SHAPE}__pod16x16__baseline"
    rec = json.loads((out / f"{cell}.json").read_text())
    if rec["status"] != "OK" or not all(
            rec[k] > 0 for k in ("t_compute", "t_memory", "t_collective")):
        raise AssertionError(f"mesh (d): {rec}")
    # deepseek-7b's heads (32), KV heads and widths divide the model axis
    # of 16: the mesh layer gathers nothing outside DTensor's rules, and
    # the step's FLOPs are the useful 6 N tokens plus attention's scores
    # and their recompute (1.38x on torch 2.13), not a replicated step's
    ratio = rec["flops_global"] / rec["model_flops"]
    if rec["gathers"] or not 1.0 <= ratio <= DRYRUN_FLOPS_RATIO:
        raise AssertionError(
            f"mesh (d): {cell} gathered outside DTensor's rules or its "
            f"FLOPs are {ratio:.3f}x model_flops (1 to "
            f"{DRYRUN_FLOPS_RATIO}): {rec['gathers']}")
    q = subprocess.run(
        [sys.executable, "-m", "repro_torch.perf.profile_cell",
         "--analysis", str(out / f"{cell}.ops.json"), "--top", "10"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    if q.returncode:
        raise AssertionError(f"mesh (d): profile_cell failed: "
                             f"{q.stderr[-2000:]}")
    terms = {k: rec[k] for k in ("flops_global", "bytes_global",
                                 "coll_bytes_global", "model_flops",
                                 "t_compute", "t_memory", "t_collective",
                                 "bottleneck", "useful_flops_frac",
                                 "roofline_frac", "memory_per_device",
                                 "lower_s", "analyze_s")}
    terms["flops_over_model_flops"] = ratio
    log(f"[mesh] (d) dry-run {cell}: {wall:.1f} s in a subprocess beside "
        f"(b), (c), (e); {json.dumps(terms)}")
    log(f"[mesh] (d) profile_cell top 10:\n{q.stdout}")
    return dict(cell=cell, wall_s=wall, **terms)


def _mesh_analyzer(cfg, sys_, served) -> dict:
    """(e) The op analyzer on the edge TorR prefix step (16 streams, the
    served traffic's first window) on the card and on the CPU: the same
    ops, FLOPs and bytes, each kernel one op."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import build, ops
    from repro_torch.perf import op_analyze

    S = len(served)
    feats = np.stack([fr[0].feats for fr in served])
    words = ops.encode_packed(feats.reshape(-1, feats.shape[-1]),
                              torch.as_tensor(sys_.R).cuda()).cpu()
    valid = np.stack([fr[0].valid for fr in served])
    boxes = np.stack([fr[0].boxes for fr in served]).astype(np.float32)
    task_w = np.stack([np.asarray(sys_.task_w[s % sys_.task_w.shape[0]])
                       for s in range(S)]).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        st = pipeline.init_multi_stream_state(cfg, task_w, device=dev)
        im = sys_.im.to(dev)
        args = (st, im, words.reshape(S, cfg.N_max, -1).to(dev),
                torch.from_numpy(valid).to(dev),
                torch.from_numpy(boxes).to(dev),
                torch.zeros(S, dtype=torch.int32, device=dev))
        _, an = op_analyze.analyze(
            lambda: pipeline.torr_multi_stream_step(*args, cfg))
        res[dev] = an
    a, b = res["cuda"], res["cpu"]
    kernels = [r.name for r in a.ops if r.name in build.SIGNATURES]
    if a.op_names() != b.op_names() or a.flops != b.flops or \
            a.bytes_traffic != b.bytes_traffic or not kernels:
        extra = sorted(set(a.op_names()) ^ set(b.op_names()))
        raise AssertionError(
            f"mesh (e): the card's analysis differs from the CPU's: "
            f"{len(a.ops)} vs {len(b.ops)} ops (only on one: {extra}), "
            f"FLOPs {a.flops} vs {b.flops}, bytes {a.bytes_traffic} vs "
            f"{b.bytes_traffic}, kernels {kernels}")
    log(f"[mesh] (e) the analyzer on the edge prefix step ({S} streams): "
        f"{len(a.ops)} ops, {a.flops:.6g} FLOPs, {a.bytes_traffic:.6g} "
        f"bytes on the card and on the CPU alike; kernels as one op each: "
        f"{kernels}")
    return dict(ops=len(a.ops), flops=a.flops, bytes=a.bytes_traffic,
                kernels=kernels)


def _mesh_decode_rank(rank, world, port, out_path):
    """(f) One rank of the 2x2 gloo mesh (a spawned process, the CPU only,
    one thread): for each of MESH_DECODE_ARCHS' smoke configs in float32,
    a plain prefill, then one decode step plain and one on the mesh from
    copies of that cache; every rank gathers the mesh step's logits and
    cache, rank 0 writes each tensor's largest difference and magnitude."""
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, mla
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        attention.BF16 = mla.BF16 = torch.float32
        res = {}
        for arch in MESH_DECODE_ARCHS:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
            params = tf.init_params(cfg, torch.Generator().manual_seed(5),
                                    "cpu")
            _lm_offsets(params, torch.Generator().manual_seed(6))
            flat = dict(params.state_dict())
            prompt = _lm_prompt(cfg, MESH_DECODE_B, MESH_DECODE_S, 7, "cpu")
            cache, _ = steps.make_prefill(
                cfg, s_max=MESH_DECODE_S + 8)(flat, prompt)
            tok = prompt["tokens"][:, -1]
            outs = {}
            for label, m in (("plain", None), ("mesh", mesh)):
                c, logits = steps.make_decode_step(cfg, mesh=m)(
                    flat, copy.deepcopy(cache), tok)
                outs[label] = [
                    (t.full_tensor() if isinstance(t, DTensor) else t)
                    .detach().double()
                    for t in [logits] + _lm_leaves(c)]
            res[arch] = dict(
                seconds=time.perf_counter() - t0,
                errs=[(float((a - b).abs().max()), float(b.abs().max()))
                      for a, b in zip(outs["mesh"], outs["plain"])])
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _start_mesh_decode():
    """(f) Start the 4 ranks (spawned, so no rank inherits the card)."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "decode.pkl")
    ctx = mp.spawn(_mesh_decode_rank, args=(4, _free_port(), out), nprocs=4,
                   join=False)
    return ctx, tmp, out, time.perf_counter()


def _mesh_decode(started) -> dict:
    """(f) Wait for the ranks (at most MESH_DECODE_LIMIT_S from their
    start, else they are killed and the phase fails) and hold the mesh
    decode step to the plain one."""
    import pickle

    ctx, tmp, out, t0 = started
    try:
        while not ctx.join(timeout=max(0.1, t0 + MESH_DECODE_LIMIT_S
                                       - time.perf_counter())):
            if time.perf_counter() - t0 > MESH_DECODE_LIMIT_S:
                raise AssertionError(
                    f"mesh (f): the 2x2 decode ranks took over "
                    f"{MESH_DECODE_LIMIT_S} s")
        wall = time.perf_counter() - t0
        with open(out, "rb") as f:
            res = pickle.load(f)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
        tmp.cleanup()
    rows = {}
    for arch, r in res.items():
        worst = max(e / max(m, 1e-30) for e, m in r["errs"])
        if worst > MESH_DECODE_TOL:
            raise AssertionError(f"mesh (f): {arch} decode on 2x2 is "
                                 f"{worst:.3g} of a tensor's largest "
                                 f"magnitude from the plain step")
        rows[arch] = dict(worst_of_max=worst, tensors=len(r["errs"]),
                          seconds=r["seconds"])
    log(f"[mesh] (f) one decode step of {', '.join(res)} (smoke, float32, "
        f"float32 scores, batch {MESH_DECODE_B}, prompt {MESH_DECODE_S}) on "
        f"a 2x2 gloo mesh of 4 CPU ranks, torch {torch.__version__}: "
        f"logits and every cache tensor within "
        + ", ".join(f"{a} {r['worst_of_max']:.3g} ({r['tensors']} tensors, "
                    f"{r['seconds']:.1f} s)" for a, r in rows.items())
        + f" of its largest magnitude (rule {MESH_DECODE_TOL}); "
        f"{wall:.1f} s with the ranks' start")
    return dict(archs=rows, seconds=wall, torch=torch.__version__)


def phase_mesh(report, cfg, sys_, served):
    """Phase 18: the mesh layer on the card. (a) The train step on a 1x1
    (data, model) mesh of a one-rank NCCL group against the plain step;
    (b) moe_ffn_ep against moe_ffn; (c) the pipeline over a pod axis of
    one rank; (d) the dry-run of a production cell and profile_cell; (e)
    the op analyzer on the card and on the CPU; (f) one decode step of
    musicgen-large's and llama-3.2-vision-90b's smoke configs on a 2x2
    gloo mesh of 4 CPU ranks against the plain step (started after (e),
    beside the dry-run's wait); (g) the int8 decode on the 1x1 mesh
    against the plain one. Only (e)'s TorR step and (g)'s ``int8_dot``
    launch hand-written kernels, counted from 0 around the phase
    (``phase18_launches``)."""
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh

    build.reset_launches()
    started = None
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        row = {"card": _smi()}
        with _lm_flags() as flags:
            row["flags"] = flags
            # (a) first, alone on the host: its ms/step is mostly host time
            row["train"] = _mesh_train(mesh)
            started = _start_dryrun()
            row["ep"] = _mesh_ep(mesh)
            row["pipeline"] = _mesh_pipeline()
            row["int8"] = _mesh_int8(mesh)
        row["analyzer"] = _mesh_analyzer(cfg, sys_, served)
    except BaseException:
        if started is not None:     # stop the dry-run with the phase
            started[0].kill()
            started[0].wait()
        raise
    finally:
        dist.destroy_process_group()
    try:
        decode = _start_mesh_decode()
    except BaseException:
        started[0].kill()
        started[0].wait()
        raise
    try:
        row["dryrun"] = _mesh_dryrun(started)
    finally:
        row["decode_2x2"] = _mesh_decode(decode)
    launches = dict(build.LAUNCHES)
    for name, r in report.items():
        r["phase18_launches"] = launches.get(name, 0)
    log(f"[mesh] launches of the hand-written kernels in phase 18: "
        f"{launches}")
    return row


# phase 19: the stream-sharded async engine at torr_edge(): 15 streams
# padded to a multiple of the shard count, over every visible card (two
# shards on cuda:0 with one card)
MESH_STREAMS = 15
MESH_PHASE_LIMIT_S = 60.0
MESH_KERNELS = ("bank_prefix_hamming", "packed_hamming_batched")


def _card_stream_mesh():
    """Every visible card, or two shards on cuda:0 with one card."""
    from repro_torch.runtime import sharding as shd

    if torch.cuda.device_count() == 1:
        return shd.stream_mesh(devices=["cuda:0", "cuda:0"])
    return shd.stream_mesh()


def _mesh_serve(cfg, sys_, frames, words, n_slots, mesh, **kw):
    """A paused ``AsyncStreamEngine`` in ``n_slots`` slots (sharded over
    ``mesh``, or not), warmed up, every window of ``frames`` queued, then
    its workers started: the results, the final cache, ms/step (start to
    the end of ``flush`` and the streams' sync), the steps and each
    shard's launches of the served run (from its graph family)."""
    from repro_torch.serving.async_engine import AsyncStreamEngine

    S, T = len(frames), len(frames[0])
    eng = AsyncStreamEngine(cfg, sys_.im, n_slots=n_slots, mesh=mesh,
                            paused=True, **kw)
    try:
        eng.warmup()
        fams = [sh.graphs for sh in eng.shards] if eng.shards else \
            [eng.graphs]
        before = [dict(f.launches) for f in fams]
        _admit_all(eng, sys_, S)
        futs = _submit_futures(eng, frames, words, T)
        t0 = time.perf_counter()
        eng.start()
        eng.flush(timeout=600)
        eng.sync()
        wall = time.perf_counter() - t0
        launches = [{k: f.launches.get(k, 0) - b.get(k, 0)
                     for k in MESH_KERNELS} for f, b in zip(fams, before)]
        res = {sid: [f.result(timeout=60) for f in fs]
               for sid, fs in futs.items()}
        cache = eng.state.cache
        steps = eng.stats.steps
    finally:
        eng.close()
    return res, cache, 1e3 * wall / steps, steps, launches, eng.n_slots


def _mesh_cli():
    """The launcher's ``--mesh``: N above the card count refused, then
    ``--mesh -1`` (every card) served."""
    import io

    from repro_torch.launch import serve

    n = torch.cuda.device_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            serve.main(["--torr-streams", "2", "--torr-frames", "1",
                        "--mesh", str(n + 1)])
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    if code != 2 or f"requested {n + 1} devices, only {n} present" \
            not in err.getvalue():
        raise AssertionError(f"mesh cli: --mesh {n + 1} on {n} card(s) was "
                             f"not refused ({code}): {err.getvalue()!r}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--torr-streams", str(MESH_STREAMS), "--torr-frames",
                    "2", "--mesh", "-1"])
    lines = [ln for ln in out.getvalue().splitlines() if "slots=" in ln]
    want = -(-MESH_STREAMS // n) * n
    if not lines or "mode=async" not in lines[0] or \
            f"slots={want}" not in lines[0] or "LOST" in out.getvalue():
        raise AssertionError(f"mesh cli: --mesh -1 printed {lines}")
    return lines[0].removeprefix("[serve/torr] ")


def phase_stream_mesh(cfg, sys_, cases, report):
    """Phase 19: ``AsyncStreamEngine(mesh=)`` at the edge config, 15
    streams padded to the shards, over every visible card (one card: two
    shards on cuda:0): the prefix and compact lowerings on the served and
    the reuse traffic (phases 3 and 4's packed words), each against the
    unsharded async engine in as many slots, outputs, telemetry and final
    caches bit-equal; ms/step of both; each shard's launches of
    ``bank_prefix_hamming`` and ``packed_hamming_batched``, every shard
    launching its lowering's kernels; then the CLI's ``--mesh``."""
    from repro_torch.runtime import sharding as shd

    t0 = time.perf_counter()
    mesh = _card_stream_mesh()
    rows = []
    for label, frames, words, kw, kernels in cases:
        frames = frames[:MESH_STREAMS]
        res_m, cache_m, ms_m, steps_m, per_shard, n_slots = _mesh_serve(
            cfg, sys_, frames, words, MESH_STREAMS, mesh, **kw)
        res_u, cache_u, ms_u, steps_u, _, _ = _mesh_serve(
            cfg, sys_, frames, words, n_slots, None, **kw)
        if steps_m != steps_u or any(
                len(res_m[sid]) != len(res_u[sid]) for sid in res_u):
            raise AssertionError(f"stream mesh {label}: {steps_m} sharded "
                                 f"steps against {steps_u}")
        _assert_results_equal(f"stream mesh {label}", res_m, res_u)
        _assert_caches_equal(f"stream mesh {label}", cache_m, cache_u)
        for k, launched in enumerate(per_shard):
            for name in kernels:
                if launched[name] < steps_m:
                    raise AssertionError(
                        f"stream mesh {label}: shard {k} launched {name} "
                        f"{launched[name]} times in {steps_m} steps")
        rows.append(dict(label=label, steps=steps_m, slots=n_slots,
                         sharded_ms_per_step=ms_m,
                         unsharded_ms_per_step=ms_u,
                         launches_per_shard=per_shard))
        log(f"[stream mesh] {label}: {MESH_STREAMS} streams in {n_slots} "
            f"slots, {len(mesh)} shards: outputs, telemetry and final "
            f"caches bit-equal to the unsharded async engine; {steps_m} "
            f"steps, ms/step sharded {ms_m:.2f} / unsharded {ms_u:.2f}; "
            f"launches a shard {per_shard}")
    for r in rows:
        for k, launched in enumerate(r["launches_per_shard"]):
            for name, n in launched.items():
                key = f"phase19_shard{k}_launches"
                report[name][key] = report[name].get(key, 0) + n
    cli = _mesh_cli()
    wall = time.perf_counter() - t0
    layout = [f"{sh} slots {lo}-{hi - 1}" for sh, (lo, hi) in zip(
        mesh, shd.stream_rows(rows[0]["slots"], mesh))]
    log(f"[stream mesh] {torch.cuda.device_count()} card(s), "
        f"{len(mesh)} shards: {layout}; CLI: {cli}; {wall:.1f} s")
    if wall > MESH_PHASE_LIMIT_S:
        raise AssertionError(f"stream mesh: {wall:.1f} s, over "
                             f"{MESH_PHASE_LIMIT_S} s")
    return dict(cards=torch.cuda.device_count(), shards=[str(d) for d in
                                                         mesh],
                layout=layout, rows=rows, cli=cli, seconds=wall)


# phase 20: the mesh on cards, one NCCL rank a card in spawned processes
MULTIPOD_STEPS, MULTIPOD_LOSS = 60, 0.5     # (e): the reference's loop


def _multipod_loop(mesh, device) -> float:
    """(e) The reference's multipod loop (``tests/test_distributed.py:
    79-113``) on a ("pod", "data", "model") mesh: least squares, each pod
    its rows of 8 numpy-drawn samples a step, the int8 compressed
    gradient sum over 'pod' divided by the pod count
    (``grad_compress.make_dp_compressed_train_step``), AdamW at lr 5e-2
    without warm-up or decay, MULTIPOD_STEPS steps; returns the last
    step's loss averaged over the pods (the reference's pmean)."""
    import torch.distributed as dist

    from repro_torch.optim import adamw
    from repro_torch.optim import grad_compress as gc

    group = mesh.get_group("pod")
    pods, pod = dist.get_world_size(group), mesh.get_local_rank("pod")
    ocfg = adamw.OptimConfig(lr=5e-2, warmup_steps=0, total_steps=100,
                             weight_decay=0.0)
    W = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 2)).astype(np.float32)).to(device)
    step = gc.make_dp_compressed_train_step(
        lambda p, b: (torch.mean((b[0] @ p["w"] - b[1]) ** 2), {}),
        lambda p, g, o: adamw.apply_updates(p, g, o, ocfg), group)
    p = {"w": torch.zeros((4, 2), device=device)}
    err, opt = gc.init_error_state(p), adamw.init_opt_state(p)
    rows = 8 // pods
    for i in range(MULTIPOD_STEPS):
        x = torch.from_numpy(np.random.default_rng(i + 1).standard_normal(
            (8, 4)).astype(np.float32)[pod * rows:(pod + 1) * rows]
        ).to(device)
        p, err, opt, m = step(p, err, opt, (x, x @ W))
    loss = m["loss"].clone()
    dist.all_reduce(loss, group=group)
    return float(loss) / pods


CARDS_LIMIT_S = 300.0
CARDS_STEPS = 4             # (a): steps compared, mesh against plain;
CARDS_MORE_STEPS = 4        # then on each mesh more timed steps, the last
#                             under torch.profiler on rank 0
CARDS_LOSS_RTOL, CARDS_MU_OF_MAX = 1e-3, 0.1    # (a): the bfloat16 rule
# (b), (d): float32 (score products too): losses and metrics rtol 1e-5,
# every other tensor within 1e-4 of its largest magnitude (nu, a square,
# 2e-4), tests/test_torch_mesh_run.py's rules
CARDS_F32_RTOL, CARDS_F32_OF_MAX = 1e-5, 1e-4
CARDS_SMOKE_B, CARDS_SMOKE_S = 4, 64
CARDS_FAMILIES = ("qwen3-14b", "musicgen-large", "llama-3.2-vision-90b",
                  "deepseek-v2-236b", "recurrentgemma-2b", "xlstm-1.3b")
CARDS_OCFG = dict(lr=1e-2, warmup_steps=1)      # (b): AdamW's first step
CARDS_INT8_ARCH = "qwen3-14b"
# (c): the mesh's int8 logits against one card's: within 2e-2 of their
# largest magnitude, or, where the bf16 cache's decode on the same mesh is
# farther than that from one card's (the dense layers' bf16 partial sums
# added in another order, 40 times over), within 1.5x that distance: the
# int8 path may add half again to the sum order's own distance
CARDS_INT8_OF_MAX, CARDS_INT8_OVER_BF16 = 2e-2, 1.5
# (f): tests/test_torch_pipeline_parallel.py's rules
CARDS_PIPE_ATOL, CARDS_PIPE_GRAD_TOL = 1e-5, 1e-4
CARDS_TRAIN_CLI = ["--arch", "gemma-7b", "--smoke", "--steps", "40",
                   "--batch", "8", "--seq", "64"]
CARDS_CLI_FAULT = ["--fault-at", "23", "--ckpt-every", "10"]
# 18 (g): qwen3-14b's widths cut to 4 layers on the 1x1 NCCL mesh
MESH_INT8_LAYERS = 4


def _decode_tokens(step, cache, toks):
    """``cache, logits = step(cache, toks[:, t])`` for every t: each
    step's whole logits and ms (synced), and the last cache."""
    logits, ms = [], []
    for t in range(toks.shape[1]):
        (cache, lg), dt = _synced_ms(lambda: step(cache, toks[:, t]))
        logits.append(_whole(lg))
        ms.append(dt)
    return logits, ms, cache


def _cards_meshes(n: int) -> dict:
    """Phase 20's mesh shapes on n (4 or 2) cards: ("data", "model")
    unless three entries, ("pod", "data", "model")."""
    if n == 4:
        return dict(train=((2, 2), (1, 4)), smoke=(2, 2), int8=(1, 4),
                    ep=(1, 4), compress=(2, 2), pod=(2, 1, 2),
                    pipe=(4, 1, 1), save=(2, 2), restore=(1, 2),
                    cli=(2, 2))
    return dict(train=((1, 2), (2, 1)), smoke=(1, 2), int8=(1, 2),
                ep=(1, 2), compress=(2, 1), pod=(2, 1, 1), pipe=(2, 1, 1),
                save=(1, 2), restore=(1, 1), cli=(2, 1))


def _mesh_of(shape):
    from repro_torch.launch.mesh import make_host_mesh

    if len(shape) == 3:
        return make_host_mesh(shape[1], shape[2], pod=shape[0],
                              device="cuda")
    return make_host_mesh(*shape, device="cuda")


def _barrier():
    import torch.distributed as dist

    dist.barrier(device_ids=[torch.cuda.current_device()])


def _on_rank0(fn):
    """``fn()`` on rank 0 while the other ranks wait at a barrier; its
    result on rank 0, None on the others."""
    import torch.distributed as dist

    out = fn() if dist.get_rank() == 0 else None
    _barrier()
    return out


def _whole(t):
    """A DTensor's full tensor (a collective: every rank calls it), a
    plain tensor as it is; detached."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _of_max(got, want) -> float:
    """max |got - want| over max |want| (float64)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30) if want.numel() else 0.0


def _free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _peak_reset():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _gather_obj(x) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _nccl_profile(fn) -> tuple:
    """``fn()`` under torch.profiler: (its result, wall ms, device busy
    ms, the NCCL kernels' device ms, the top NCCL kernels). The device
    rows of user annotations (c10d's ``nccl:all_reduce`` ranges span the
    kernels they launch) are left out, so no kernel counts twice."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall = _synced_ms(fn)
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us and "CUDA" in str(getattr(evt, "device_type", "")) and \
                evt.key not in ranges and not evt.key.startswith("nccl:"):
            kernels.append((us / 1e3, evt.key, evt.count))
    kernels.sort(reverse=True)
    nccl = [k for k in kernels if "nccl" in k[1].lower()]
    return (out, wall, sum(k[0] for k in kernels), sum(k[0] for k in nccl),
            [dict(name=k[1][:90], ms=k[0], calls=k[2]) for k in nccl[:6]])


def _cards_train(shapes) -> dict:
    """(a) Phase 17's cell (deepseek-7b's widths, 4 of 30 layers, bf16,
    remat "nothing", AdamW, 4 x 2048 TokenStream tokens) for CARDS_STEPS
    steps plain on rank 0's card, then on each mesh of ``shapes`` from
    the same seed: every step's loss within rtol CARDS_LOSS_RTOL and mu
    after them within CARDS_MU_OF_MAX of each leaf's largest; then
    CARDS_MORE_STEPS more on the mesh, the last profiled on rank 0. ms/step
    (median after the first: a mesh's first steps start DTensor's
    propagation and NCCL's communicators), tokens/s, each card's peak
    memory_allocated, the NCCL kernels' device ms in the profiled step."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.data.tokens import TokenStream
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat_policy="nothing")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [stream.batch_at(i)
               for i in range(CARDS_STEPS + CARDS_MORE_STEPS)]
    ocfg = adamw.OptimConfig(**TRAIN_OPT)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def plain():
        _peak_reset()
        state = steps.init_train_state(cfg, seed=0, device="cuda")
        params, opt = state["params"], state["opt"]
        del state
        step = steps.make_train_step(cfg, ocfg, device="cuda")
        ms, losses = [], []
        for b in batches[:CARDS_STEPS]:
            (params, opt, m), t = _synced_ms(lambda: step(params, opt, b))
            ms.append(t)
            losses.append(float(m["loss"]))
        mu = opt["mu"]
        peak = torch.cuda.max_memory_allocated()
        del params, opt, m, step
        _free_card()
        return dict(ms=ms, losses=losses, mu=mu, peak_bytes=peak)

    ref = _on_rank0(plain)
    rows = []
    for shape in shapes:
        mesh = _mesh_of(shape)
        _peak_reset()
        state = steps.init_train_state(cfg, seed=0, device="cuda")
        params = shd.distribute(state["params"], shd.params_sharding(
            state["params"], mesh))
        opt = shd.distribute(state["opt"], shd.params_sharding(
            state["opt"], mesh))
        del state
        _free_card()
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        ms, losses, worst = [], [], 0.0
        for i, b in enumerate(batches):
            if i < len(batches) - 1:
                (params, opt, m), t = _synced_ms(
                    lambda: step(params, opt, b))
                ms.append(t)
            elif dist.get_rank() == 0:
                (params, opt, m), wall, busy, nccl, top = _nccl_profile(
                    lambda: step(params, opt, b))
            else:
                params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            if i == CARDS_STEPS - 1:        # mu where the plain run ended
                for k in sorted(opt["mu"]):
                    got = _whole(opt["mu"][k])
                    if ref is not None:
                        worst = max(worst, _of_max(got, ref["mu"][k]))
                    del got
        peaks = _gather_obj(torch.cuda.max_memory_allocated())
        del params, opt, m, step
        _free_card()
        if ref is None:
            continue
        bad = [(a, b) for a, b in zip(losses, ref["losses"])
               if abs(a - b) > CARDS_LOSS_RTOL * abs(b)]
        if bad or worst > CARDS_MU_OF_MAX:
            raise AssertionError(
                f"mesh cards (a) {shape}: losses {losses} against plain "
                f"{ref['losses']}, mu {worst:.3g} of a leaf's largest "
                f"(rules rtol {CARDS_LOSS_RTOL}, {CARDS_MU_OF_MAX})")
        med = statistics.median(ms[1:])
        rows.append(dict(mesh=list(shape), losses=losses, ms=ms,
                         ms_per_step=med, tokens_per_s=tokens / med * 1e3,
                         mu_of_max=worst, peak_bytes=peaks,
                         profiled_wall_ms=wall, busy_ms=busy, nccl_ms=nccl,
                         nccl_share=nccl / wall, top_nccl=top))
    if ref is None:
        return None
    med = statistics.median(ref["ms"][1:])
    return dict(arch=TRAIN_ARCH, layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=CARDS_STEPS,
                plain=dict(losses=ref["losses"], ms=ref["ms"],
                           ms_per_step=med, tokens_per_s=tokens / med * 1e3,
                           peak_bytes=ref["peak_bytes"]),
                meshes=rows)


def _cards_smoke_family(arch, mesh) -> dict | None:
    """(b) One family's smoke config in float32 (float32 score products):
    the train step (AdamW's first), prefill (capacity S + 8), one decode
    step, and for the dense and MoE families one int8 decode step from
    ``init_cache``, plain on rank 0's card and on ``mesh``; the largest
    error of each against its rule."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.tokens import TokenStream, to_device
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cfgq = dataclasses.replace(cfg, serve_quant="int8")
    params = tf.init_params(cfg, torch.Generator("cuda").manual_seed(5),
                            "cuda")
    _lm_offsets(params, torch.Generator("cuda").manual_seed(6))
    flat = {k: v.detach() for k, v in params.state_dict().items()}
    del params
    batch = TokenStream(cfg, CARDS_SMOKE_B, CARDS_SMOKE_S).batch_at(0)
    prompt = {k: v for k, v in to_device(batch, "cuda").items()
              if k in ("tokens", "vision")}
    last = prompt["tokens"][:, -1]
    ocfg = adamw.OptimConfig(**CARDS_OCFG)
    int8 = cfg.family in ("dense", "moe")
    S = CARDS_SMOKE_S

    def run(mesh):
        placed = flat if mesh is None else shd.distribute(
            flat, shd.params_sharding(flat, mesh))
        out = {}
        step = steps.make_train_step(cfg, ocfg, device="cuda", mesh=mesh)
        _, opt, m = step(placed, adamw.init_opt_state(flat), batch)
        out["metrics"] = {k: float(_whole(v)) for k, v in m.items()}
        out["mu"] = {k: _whole(v) for k, v in opt["mu"].items()}
        out["nu"] = {k: _whole(v) for k, v in opt["nu"].items()}
        cache, logits = steps.make_prefill(cfg, s_max=S + 8, mesh=mesh)(
            placed, prompt)
        out["prefill"] = [_whole(t).clone() for t in
                          [logits] + _lm_leaves(cache)]
        cache, logits = steps.make_decode_step(cfg, mesh=mesh)(
            placed, cache, last)
        out["decode"] = [_whole(t) for t in [logits] + _lm_leaves(cache)]
        if int8:
            cq = tf.init_cache(cfgq, CARDS_SMOKE_B, S + 8, "cuda")
            cq, lq = steps.make_decode_step(cfgq, mesh=mesh)(placed, cq,
                                                             last)
            out["int8 decode"] = [_whole(t) for t in [lq] + _lm_leaves(cq)]
        return out

    ref = _on_rank0(lambda: run(None))
    got = run(mesh)
    if ref is None:
        return None
    errs = {}
    for k, want in ref["metrics"].items():
        if abs(got["metrics"][k] - want) > CARDS_F32_RTOL * abs(want) + 1e-7:
            raise AssertionError(f"mesh cards (b) {arch}: {k} "
                                 f"{got['metrics'][k]} against {want}")
    errs["metrics_rel"] = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                              for k, v in ref["metrics"].items())
    for name, rule in (("mu", CARDS_F32_OF_MAX), ("nu", 2 * CARDS_F32_OF_MAX)):
        errs[name] = max(_of_max(got[name][k], v)
                         for k, v in ref[name].items())
        if errs[name] > rule:
            raise AssertionError(f"mesh cards (b) {arch}: {name} "
                                 f"{errs[name]:.3g} of a leaf's largest")
    for step in ("prefill", "decode", "int8 decode"):
        if step not in ref:
            continue
        errs[step] = max(_of_max(a, b) for a, b in zip(got[step], ref[step]))
        if errs[step] > CARDS_F32_OF_MAX:
            raise AssertionError(f"mesh cards (b) {arch} {step}: "
                                 f"{errs[step]:.3g} of a tensor's largest")
    return errs


def _cards_int8(shape) -> dict:
    """(c) The int8 decode at CARDS_INT8_ARCH's full config (bf16 random
    weights from seed 0, batch REC_BATCH, INT8_T tokens from
    ``init_cache``, S_max INT8_S_MAX): on one card (rank 0) and on the
    mesh, where the bf16 cache's decode runs too (and on one card beside
    the int8 one). Each mesh step's softmax within INT8_SOFTMAX_TOL of the
    bf16 cache's on the mesh, its logits within the larger of
    CARDS_INT8_OF_MAX and CARDS_INT8_OVER_BF16 times the bf16 cache's own
    mesh-to-card distance, of their largest magnitude of one card's; ``int8_dot`` launches on each rank counted from 0 around the
    mesh's int8 run; ms/token (median after the first) of both."""
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = get(CARDS_INT8_ARCH)
    cfgq = dataclasses.replace(cfg, serve_quant="int8")
    toks = _lm_prompt(cfg, REC_BATCH, INT8_T, 9, "cuda")["tokens"]

    def weights():
        return tf.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                              "cuda")

    def decode(c, step):
        return _decode_tokens(step, tf.init_cache(c, REC_BATCH, INT8_S_MAX,
                                                  "cuda"), toks)[:2]

    def plain():
        params = weights()
        out = decode(cfgq, lambda c, tok: tf.decode_step(params, c, tok,
                                                         cfgq))
        bf16 = decode(cfg, lambda c, tok: tf.decode_step(params, c, tok,
                                                         cfg))[0]
        del params
        _free_card()
        return (*out, bf16)

    ref = _on_rank0(plain)
    mesh = _mesh_of(shape)
    full = dict(weights().state_dict())
    specs = shd.params_sharding(full, mesh)
    placed = {}
    for k in list(full):
        placed[k] = shd.distribute(full.pop(k).detach(), specs[k])
    del full
    _free_card()
    step_b = steps.make_decode_step(cfg, mesh=mesh)
    logits_b, _ = decode(cfg, lambda c, tok: step_b(placed, c, tok))
    step_q = steps.make_decode_step(cfgq, mesh=mesh)
    build.reset_launches()
    logits_q, ms = decode(cfgq, lambda c, tok: step_q(placed, c, tok))
    launches = _gather_obj(build.LAUNCHES["int8_dot"])
    del placed
    _free_card()
    if ref is None:
        return None
    want = 2 * cfg.n_layers * INT8_T
    if any(n != want for n in launches):
        raise AssertionError(f"mesh cards (c): int8_dot launched {launches} "
                             f"times a rank, {want} expected")
    sm = max(float((torch.softmax(a.float(), -1)
                    - torch.softmax(b.float(), -1)).abs().max())
             for a, b in zip(logits_b, logits_q))
    of_max = max(_of_max(a, b) for a, b in zip(logits_q, ref[0]))
    # beside it, the bf16 cache's decode on the mesh against one card's
    bf16_of_max = max(_of_max(a, b) for a, b in zip(logits_b, ref[2]))
    rule = max(CARDS_INT8_OF_MAX, CARDS_INT8_OVER_BF16 * bf16_of_max)
    if not sm < INT8_SOFTMAX_TOL or of_max > rule:
        raise AssertionError(
            f"mesh cards (c): softmax {sm:.3g} from the bf16 cache's (rule "
            f"{INT8_SOFTMAX_TOL}), logits {of_max:.3g} of their largest from "
            f"one card's (rule {rule:.3g}; the bf16 cache's decode "
            f"{bf16_of_max:.3g})")
    return dict(arch=CARDS_INT8_ARCH, layers=cfg.n_layers, mesh=list(shape),
                batch=REC_BATCH, tokens=INT8_T, max_softmax_diff=sm,
                logits_of_max=of_max, bf16_logits_of_max=bf16_of_max,
                logits_rule=rule,
                int8_dot_launches=launches,
                mesh_ms_per_token=statistics.median(ms[1:]),
                card_ms_per_token=statistics.median(ref[1][1:]),
                mesh_ms=ms, card_ms=ref[1])


def _cards_ep(shape) -> dict:
    """(d) moe_ffn_ep over every rank at EP_ARCH's MoE widths in float32
    (TF32 off), against moe_ffn on rank 0's card: forward and the
    gradients of mean(y^2) + aux (each timed twice, the second kept)."""
    from types import SimpleNamespace

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get
    from repro_torch.models import moe
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd

    cfg = get(EP_ARCH)

    def draw():
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = moe.init_moe_params(cfg, torch.float32, generator=gen,
                                device="cuda")
        flat = {k: v.detach() for k, v in p.state_dict().items()}
        x = torch.randn(EP_BATCH, EP_SEQ, cfg.d_model, generator=gen,
                        device="cuda")
        return flat, x

    def plain():
        flat, x = draw()
        leaves = {k: v.requires_grad_(True) for k, v in flat.items()}
        x.requires_grad_(True)
        for _ in range(2):
            y, aux, ms = _grads_of(lambda: moe.moe_ffn(
                SimpleNamespace(**leaves), x, cfg), {**leaves, "x": x})
        out = (y.detach(), float(aux), {k: v.grad for k, v in leaves.items()}
               | {"x": x.grad}, ms)
        del leaves, x, y
        _free_card()
        return out

    ref = _on_rank0(plain)
    mesh = _mesh_of(shape)
    flat, x = draw()
    dp = {k: distribute_tensor(flat.pop(k), mesh, shd.placements(
        EP_SPECS[k], mesh)).requires_grad_(True) for k in list(flat)}
    xs = distribute_tensor(x, mesh, shd.placements(
        ("data", None, None), mesh)).requires_grad_(True)
    del x
    _free_card()
    ep_cfg = dataclasses.replace(cfg, moe_groups=1)
    with spmd.mesh_mode():
        for _ in range(2):
            y, aux, ms = _grads_of(lambda: moe.moe_ffn(
                SimpleNamespace(**dp), xs, ep_cfg, mesh=mesh),
                {**dp, "x": xs})
    y, aux = _whole(y), float(_whole(aux))
    errs = {}
    for k, t in list(dp.items()) + [("x", xs)]:
        g = _whole(t.grad)          # every rank gathers, rank 0 compares
        if ref is not None:
            errs[k] = _of_max(g, ref[2][k])
        del g
    del dp, xs
    _free_card()
    if ref is None:
        return None
    y_err = _of_max(y, ref[0])
    if y_err > CARDS_F32_OF_MAX or abs(aux - ref[1]) > \
            CARDS_F32_RTOL * abs(ref[1]) or max(errs.values()) > \
            CARDS_F32_OF_MAX:
        raise AssertionError(f"mesh cards (d): moe_ffn_ep y {y_err:.3g}, aux "
                             f"{aux} against {ref[1]}, gradients {errs}")
    return dict(arch=EP_ARCH, mesh=list(shape), experts=cfg.n_experts,
                experts_a_rank=cfg.n_experts // shape[1],
                d_model=cfg.d_model, moe_d_ff=cfg.moe_d_ff,
                top_k=cfg.moe_top_k, shared=cfg.n_shared_experts,
                tokens=EP_BATCH * EP_SEQ, y_of_max=y_err,
                aux=aux, aux_plain=ref[1], grad_of_max=max(errs.values()),
                ep_ms=ms, plain_ms=ref[3])


def _cards_compressed(shape, pod_shape) -> dict:
    """(e) ``compressed_psum`` over the data axis against the exact sum,
    then the reference's multipod loop on ``pod_shape``."""
    import torch.distributed as dist

    from repro_torch.optim import grad_compress as gc

    mesh = _mesh_of(shape)
    group = mesh.get_group("data")
    g = torch.from_numpy(np.random.default_rng(dist.get_rank())
                         .standard_normal((1024, 256)).astype(np.float32)
                         ).cuda()
    summed, err = gc.compressed_psum(g, torch.zeros_like(g), group)
    exact = gc.all_gather(g, group).sum(0)
    q, s, _ = gc.ef_compress(g, torch.zeros_like(g))
    # each rank's error against its own group's bound
    errs = _gather_obj((
        float((summed - exact).abs().max()),
        float(gc.all_gather(s.reshape(1), group).sum()) / 2 * 1.0001,
        float((err - (g - q.float() * s)).abs().max())))
    loss = _multipod_loop(_mesh_of(pod_shape), "cuda")
    if any(e > b or r > 1e-6 for e, b, r in errs) or \
            not loss < MULTIPOD_LOSS:
        raise AssertionError(f"mesh cards (e): compressed sum, its bound and "
                             f"the residual a rank {errs}, multipod loss "
                             f"{loss} (rule < {MULTIPOD_LOSS})")
    return dict(mesh=list(shape), err=max(e for e, _, _ in errs),
                of_bound=max(e / b for e, b, _ in errs),
                pod_mesh=list(pod_shape), multipod_loss=loss)


def _cards_pipeline(shape) -> dict:
    """(f) ``pipeline_apply`` over the pod axis, PIPE_LAYERS / stages
    layers a stage, against the sequential model on rank 0's card:
    forward and the gradients of sum(out^2); ms of both."""
    import torch.distributed as dist

    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                        split_stages)

    W, xs = _pipe_inputs()

    def sequential():
        Ws = W.clone().requires_grad_(True)

        def run():
            Ws.grad = None
            seq = torch.stack([_pipe_stage(Ws, xs[i])
                               for i in range(PIPE_MICRO)])
            torch.sum(seq ** 2).backward()
            return seq.detach()
        run()
        seq, ms = _synced_ms(run)
        return seq, Ws.grad, ms

    ref = _on_rank0(sequential)
    mesh = _mesh_of(shape)
    group = mesh.get_group("pod")
    Wp = W.clone().requires_grad_(True)

    def piped():
        Wp.grad = None
        out = pipeline_apply(_pipe_stage, split_stages(Wp, shape[0]), xs,
                             mesh, "pod")
        torch.sum(out ** 2).backward()
        return out.detach()
    piped()
    out, ms = _synced_ms(piped)
    grad = Wp.grad.clone()
    dist.all_reduce(grad, group=group)     # each stage holds its slice
    if ref is None:
        return None
    f_err = float((out - ref[0]).abs().max())
    bad = (grad - ref[1]).abs() > CARDS_PIPE_GRAD_TOL * (1 + ref[1].abs())
    g_err = float((grad - ref[1]).abs().max())
    if f_err > CARDS_PIPE_ATOL or bool(bad.any()):
        raise AssertionError(f"mesh cards (f): pipeline {f_err} (forward), "
                             f"{g_err} (gradients) from the sequential model")
    return dict(mesh=list(shape), stages=shape[0],
                layers_a_stage=PIPE_LAYERS // shape[0], forward_err=f_err,
                grad_err=g_err, pipeline_ms=ms, sequential_ms=ref[2])


def _cards_elastic(save_shape, restore_shape, ckpt_dir) -> dict:
    """(g) gemma-7b's smoke parameters saved by CheckpointManager from
    ``save_shape`` and restored onto ``restore_shape`` over the first
    ranks (the reference's "after losing a pod"): bit for bit, placed as
    the smaller mesh's rules say."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    params = steps.init_train_state(get_smoke("gemma-7b"), seed=3,
                                    device="cuda")["params"]
    mesh_a = _mesh_of(save_shape)
    cm = CheckpointManager(ckpt_dir)
    cm.save(7, shd.distribute(params, shd.params_sharding(params, mesh_a)))
    n = math.prod(restore_shape)
    mesh_b = DeviceMesh("cuda", np.arange(n).reshape(restore_shape),
                        mesh_dim_names=("data", "model"))
    out = None
    if dist.get_rank() < n:
        sh = shd.params_sharding(params, mesh_b)
        template = shd.distribute(params, sh)
        got, step = cm.restore(template, shardings=sh)
        equal = all(torch.equal(_whole(got[k]), params[k]) for k in params)
        placed = all(got[k].placements == template[k].placements
                     for k in params)
        out = dict(step=step, equal=equal, placements=placed)
    _barrier()
    if dist.get_rank() == 0 and out != dict(step=7, equal=True,
                                            placements=True):
        raise AssertionError(f"mesh cards (g): restored {out}")
    return dict(saved_on=list(save_shape), restored_on=list(restore_shape),
                leaves=len(params), **(out or {}))


def _cards_rank(rank, world, port, out_path, ckpt_dir):
    """One rank of phase 20 (a spawned process, its own card, one NCCL
    group): (a)-(g) in turn; rank 0 pickles the rows, each part's
    seconds and every rank's ``int8_dot`` launches."""
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.models import attention, mla

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    try:
        shapes = _cards_meshes(world)
        res, secs = {}, {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            secs[name] = now - t
            t = now

        with _lm_flags():
            res["train"] = _cards_train(shapes["train"])
            lap("a")
            attention.BF16 = mla.BF16 = torch.float32
            mesh = _mesh_of(shapes["smoke"])
            res["smoke"] = {a: _cards_smoke_family(a, mesh)
                            for a in CARDS_FAMILIES}
            attention.BF16 = mla.BF16 = torch.bfloat16
            lap("b")
            res["int8"] = _cards_int8(shapes["int8"])
            lap("c")
            res["ep"] = _cards_ep(shapes["ep"])
            lap("d")
            res["compressed"] = _cards_compressed(shapes["compress"],
                                                  shapes["pod"])
            lap("e")
            res["pipeline"] = _cards_pipeline(shapes["pipe"])
            lap("f")
            res["elastic"] = _cards_elastic(shapes["save"],
                                            shapes["restore"], ckpt_dir)
            lap("g")
        res["seconds"] = secs
        res["shapes"] = shapes
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
        _barrier()
    finally:
        dist.destroy_process_group()


def _cards_cli(n, shape, ckpt, limit_s) -> dict:
    """(h) The trainer's CLI on the cards: ``torch.distributed.run
    --standalone --nproc-per-node n -m repro_torch.launch.train`` with
    CARDS_TRAIN_CLI over ``shape``, clean and with a fault at step 23
    (``--ckpt-every 10``), both at once, their checkpoints under ``ckpt``;
    each must exit 0 and print "loss improved", the faulted run
    "restarts=1"."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
            *CARDS_TRAIN_CLI, "--data-axis", str(shape[0]), "--model-axis",
            str(shape[1])]
    runs = {"clean": base + ["--ckpt", str(ckpt / "clean")],
            "fault": base + CARDS_CLI_FAULT + ["--ckpt", str(ckpt / "fault")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, cmd in runs.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=max(
                1.0, limit_s - (time.perf_counter() - t0)))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for k, p in procs.items():
        ok = p.returncode == 0 and "loss improved" in outs[k] and (
            k == "clean" or "restarts=1" in outs[k])
        if not ok:
            raise AssertionError(f"mesh cards (h) {k}: exit {p.returncode}: "
                                 f"{outs[k][-3000:]}")
    # every rank prints the summary: rank 0's first one
    summary = {k: o[o.index("[train] arch="):].split(" device=")[0]
               for k, o in outs.items()}
    return dict(mesh=list(shape), seconds=secs, summary=summary)


def phase_mesh_cards(report) -> dict:
    """Phase 20: the mesh on cards, one NCCL rank a card in n spawned
    processes (n = 4 with four cards or more, 2 with two or three): (a)
    phase 17's cell on two meshes against one card; (b) the six
    families' smoke steps; (c) the int8 decode at qwen3-14b's full
    config; (d) moe_ffn_ep; (e) the compressed sum and the multipod loop;
    (f) the pipeline; (g) the elastic restore; then (h) the trainer's
    CLI under torch.distributed.run. Within CARDS_LIMIT_S of the ranks'
    start, else the ranks are killed and the phase fails. With one card
    it does not run (NCCL puts one rank on a card)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    if cards < 2:
        log("[mesh cards] phase 20 needs two cards or more (NCCL puts one "
            "rank on a card): not run on this host; on a host with four "
            "cards run it alone with `python3 chip_smoke.py --phases "
            "mesh-cards`")
        if "int8_dot" in report:
            report["int8_dot"]["phase20_launches"] = None
        return dict(cards=cards, run=False)
    n = 4 if cards >= 4 else 2
    _free_card()
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "cards.pkl")
    t0 = time.perf_counter()
    ctx = mp.spawn(_cards_rank, args=(n, _free_port(), out,
                                      os.path.join(tmp.name, "ckpt")),
                   nprocs=n, join=False)
    try:
        while not ctx.join(timeout=max(0.1, t0 + CARDS_LIMIT_S
                                       - time.perf_counter())):
            if time.perf_counter() - t0 > CARDS_LIMIT_S:
                raise AssertionError(f"mesh cards: the {n} ranks took over "
                                     f"{CARDS_LIMIT_S} s")
        ranks_s = time.perf_counter() - t0
        with open(out, "rb") as f:
            res = pickle.load(f)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
        tmp.cleanup()
    shapes = res["shapes"]
    with tempfile.TemporaryDirectory() as ckpt:
        res["cli"] = _cards_cli(n, shapes["cli"], Path(ckpt),
                                CARDS_LIMIT_S - (time.perf_counter() - t0))
    wall = time.perf_counter() - t0
    if wall > CARDS_LIMIT_S:
        raise AssertionError(f"mesh cards: {wall:.1f} s, over "
                             f"{CARDS_LIMIT_S} s")
    card = _smi()
    a = res["train"]
    log(f"[mesh cards] {n} ranks on {n} cards ({card}), NCCL, torch "
        f"{torch.__version__}; seconds {json.dumps(res['seconds'])}, the "
        f"ranks {ranks_s:.1f} s, the CLI {res['cli']['seconds']:.1f} s, "
        f"{wall:.1f} s in all (rule {CARDS_LIMIT_S})")
    log(f"[mesh cards] (a) {a['arch']} {a['layers']} layers, bf16, "
        f"{a['batch']} x {a['seq']} tokens, {a['steps']} steps: plain "
        f"{a['plain']['ms_per_step']:.2f} ms/step "
        f"({a['plain']['tokens_per_s']:.0f} tok/s, peak "
        f"{a['plain']['peak_bytes'] / 2**30:.2f} GiB)")
    for r in a["meshes"]:
        log(f"[mesh cards] (a) mesh {r['mesh']}: {r['ms_per_step']:.2f} "
            f"ms/step ({r['tokens_per_s']:.0f} tok/s), the first "
            f"{CARDS_STEPS} losses within {CARDS_LOSS_RTOL} of plain "
            f"({r['losses'][:CARDS_STEPS]}), mu "
            f"{r['mu_of_max']:.3g} of a leaf's largest; peak per card "
            f"{[round(b / 2**30, 2) for b in r['peak_bytes']]} GiB; profiled "
            f"step on rank 0: wall {r['profiled_wall_ms']:.1f} ms, device "
            f"busy {r['busy_ms']:.1f} ms, NCCL kernels {r['nccl_ms']:.1f} ms "
            f"({r['nccl_share'] * 100:.1f} % of the step)")
        for k in r["top_nccl"]:
            log(f"[mesh cards] (a)   {k['ms']:9.2f} ms {k['calls']:5d} x "
                f"{k['name']}")
    for arch, e in res["smoke"].items():
        log(f"[mesh cards] (b) {arch} smoke, float32, mesh {shapes['smoke']}:"
            f" " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    c = res["int8"]
    log(f"[mesh cards] (c) int8 decode, {c['arch']} full config "
        f"({c['layers']} layers), mesh {c['mesh']}, batch {c['batch']}, "
        f"{c['tokens']} tokens: softmax {c['max_softmax_diff']:.3g} from the "
        f"bf16 cache's (rule {INT8_SOFTMAX_TOL}), logits "
        f"{c['logits_of_max']:.3g} of their largest from one card's (rule "
        f"{c['logits_rule']:.3g}: {CARDS_INT8_OF_MAX}, or "
        f"{CARDS_INT8_OVER_BF16}x the bf16 cache's decode on the mesh, "
        f"{c['bf16_logits_of_max']:.3g} from one card's); int8_dot launches "
        f"a rank "
        f"{c['int8_dot_launches']}; {c['mesh_ms_per_token']:.2f} ms/token on "
        f"the mesh, {c['card_ms_per_token']:.2f} on one card (eager)")
    d = res["ep"]
    log(f"[mesh cards] (d) moe_ffn_ep over {d['mesh']} ({d['experts']} "
        f"experts, {d['experts_a_rank']} a rank), float32, {d['tokens']} "
        f"tokens: y {d['y_of_max']:.3g}, gradients {d['grad_of_max']:.3g} of "
        f"their largest, aux {d['aux']} / {d['aux_plain']}; forward + "
        f"backward {d['ep_ms']:.2f} ms, moe_ffn on one card "
        f"{d['plain_ms']:.2f} ms")
    e = res["compressed"]
    log(f"[mesh cards] (e) compressed_psum over data ({e['mesh']}): "
        f"{e['err']:.3g} from the exact sum, {e['of_bound']:.3g} of half a "
        f"quantization step a rank; the "
        f"multipod loop on {e['pod_mesh']}: loss {e['multipod_loss']:.4g} "
        f"(rule < {MULTIPOD_LOSS})")
    f_ = res["pipeline"]
    log(f"[mesh cards] (f) pipeline over {f_['stages']} stages "
        f"({f_['layers_a_stage']} of {PIPE_LAYERS} layers of width {PIPE_D} "
        f"a stage, {PIPE_MICRO} microbatches of {PIPE_MB}): forward "
        f"{f_['forward_err']:.3g}, gradients {f_['grad_err']:.3g} from the "
        f"sequential model; {f_['pipeline_ms']:.2f} ms against "
        f"{f_['sequential_ms']:.2f} ms on one card")
    g = res["elastic"]
    log(f"[mesh cards] (g) gemma-7b smoke saved on {g['saved_on']}, "
        f"restored on {g['restored_on']}: {g['leaves']} leaves bit-equal, "
        f"placed by the smaller mesh's rules")
    h = res["cli"]
    log(f"[mesh cards] (h) torch.distributed.run --nproc-per-node {n}, "
        f"mesh {h['mesh']}: {json.dumps(h['summary'])}")
    if "int8_dot" in report:
        report["int8_dot"]["phase20_launches"] = c["int8_dot_launches"]
    return dict(cards=cards, run=True, ranks=n, card=card,
                torch=torch.__version__, wall_s=wall, ranks_s=ranks_s, **res)


def _mesh_int8(mesh) -> dict:
    """18 (g) The int8 decode on the 1x1 NCCL mesh: qwen3-14b's widths
    cut to MESH_INT8_LAYERS layers (bf16 random weights from seed 0,
    batch REC_BATCH, INT8_T tokens from ``init_cache``), plain and on the
    mesh: every step's logits and the final cache bit-equal, ``int8_dot``
    launched twice a layer and step in each run; ms/token of both."""
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get(CARDS_INT8_ARCH),
                              n_layers=MESH_INT8_LAYERS, serve_quant="int8")
    params = tf.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    flat = {k: v.detach() for k, v in params.state_dict().items()}
    toks = _lm_prompt(cfg, REC_BATCH, INT8_T, 9, "cuda")["tokens"]
    mesh_step = steps.make_decode_step(cfg, mesh=mesh)
    placed = shd.distribute(flat, shd.params_sharding(flat, mesh))

    def plain(cache, tok):
        return tf.decode_step(params, cache, tok, cfg)

    def on_mesh(cache, tok):
        return mesh_step(placed, cache, tok)

    runs = {}
    for label, step in (("plain", plain), ("mesh", on_mesh)):
        n0 = build.LAUNCHES["int8_dot"]
        logits, ms, cache = _decode_tokens(step, tf.init_cache(
            cfg, REC_BATCH, INT8_S_MAX, "cuda"), toks)
        runs[label] = dict(logits=logits, ms=ms,
                           launches=build.LAUNCHES["int8_dot"] - n0,
                           cache=[_whole(x) for x in _lm_leaves(cache)])
    a, b = runs["plain"], runs["mesh"]
    want = 2 * cfg.n_layers * INT8_T
    differ = [t for t in range(INT8_T)
              if not bits_equal(a["logits"][t], b["logits"][t])]
    cache_equal = all(bits_equal(x, y) for x, y in zip(a["cache"],
                                                       b["cache"]))
    if differ or not cache_equal or a["launches"] != want or \
            b["launches"] != want:
        raise AssertionError(
            f"mesh (g): the int8 decode on the 1x1 mesh differs from the "
            f"plain one at steps {differ} (cache equal: {cache_equal}); "
            f"int8_dot launched {a['launches']} / {b['launches']} times, "
            f"{want} expected")
    row = dict(arch=CARDS_INT8_ARCH, layers=cfg.n_layers, batch=REC_BATCH,
               tokens=INT8_T, bit_equal=True, int8_dot_launches=b["launches"],
               plain_ms_per_token=statistics.median(a["ms"][1:]),
               mesh_ms_per_token=statistics.median(b["ms"][1:]))
    log(f"[mesh] (g) int8 decode of {CARDS_INT8_ARCH}'s widths at "
        f"{cfg.n_layers} layers (bf16, batch {REC_BATCH}, {INT8_T} tokens "
        f"from init_cache) on the 1x1 NCCL mesh: every step's logits and "
        f"the final cache bit-equal to the plain int8 decode; int8_dot "
        f"launched {b['launches']} times ({want} expected); ms/token plain "
        f"{row['plain_ms_per_token']:.2f}, mesh "
        f"{row['mesh_ms_per_token']:.2f} (DTensor's host time)")
    del params, flat, placed, runs
    _free_card()
    return row


def phase_mesh_int8() -> dict:
    """18 (g) alone (``--phases mesh-cards``): a one-rank NCCL group of
    its own around :func:`_mesh_int8`."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        with _lm_flags():
            return _mesh_int8(make_host_mesh(1, 1, device="cuda"))
    finally:
        dist.destroy_process_group()


PHASES = ("all", "mesh-cards")


def _result_line() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--phases", choices=PHASES, default="all",
                    help="mesh-cards: the card, the build, 18 (g) and 20 "
                    "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.phases == "mesh-cards":
        t_start = time.perf_counter()
        phase_card()
        phase_build()
        int8_row = phase_mesh_int8()
        cards_row = phase_mesh_cards({})
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"mesh_int8": int8_row}))
        print(json.dumps({"mesh_cards": cards_row}))
        _result_line()
        return 0
    from repro_torch.configs.torr_edge import torr_edge
    from repro_torch.data import tood_synth as ts
    from repro_torch.perf.profile_step import edge_windows
    from repro_torch.serving import tood_pipelines as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = t_phase = time.perf_counter()

    def done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"[phase] {name}: {now - t_phase:.1f} s")
        t_phase = now

    phase_card()
    phase_build()
    done("card and build")
    cfg = torr_edge()
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim, n_tasks=5)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))
    rates = Rates()
    im_cuda = sys_.im.to("cuda")
    report = phase_kernels(cfg, im_cuda, rates)
    done("kernels")

    served = edge_windows(world, cfg, STREAMS, WINDOWS, cfg.N_max)
    reuse = edge_windows(world, cfg, STREAMS, REUSE_WINDOWS, cfg.K)
    runs = []            # the captured runs phase_eager repeats eagerly
    cpu_checks = []      # the CPU engines' checks, run once they have ended
    base = phase_serving(cfg, sys_, served, report, "serve", CPU_WINDOWS,
                         runs, cpu_checks)
    base_reuse = phase_serving(cfg, sys_, reuse, report,
                               f"reuse, windows cut to K={cfg.K} proposals",
                               CPU_WINDOWS, runs, cpu_checks)
    mix = _path_mix(reuse, base_reuse[0])
    if mix["bypass"] <= 0 or mix["delta"] <= 0:
        raise AssertionError("reuse traffic: no bypass or no delta after "
                             "the first windows")
    done("serving (prefix; its two CPU references started beside it)")

    switch = (FUSED_SWITCH, DECIDE_NONE, 0)
    compact = (FUSED_COMPACT, DECIDE_BATCHED, None)
    prefix = (FUSED_PREFIX, DECIDE_NONE, 0)
    _, res = phase_lowering(
        cfg, sys_, served, report, "serial switch, served", base,
        ("fused_scores", "delta_update"), (switch,), runs,
        n_windows=SERIAL_WINDOWS, serial=True)
    _delta_median(cfg, im_cuda.dmajor, _delta_fill_counts(cfg, served, res),
                  report, rates)
    phase_lowering(cfg, sys_, reuse, report, "serial switch, reuse",
                   base_reuse, ("fused_scores", "delta_update"), (switch,),
                   runs, n_windows=SERIAL_WINDOWS, serial=True)
    full_tier = (FUSED_COMPACT, DECIDE_BATCHED, STREAMS * cfg.N_max)
    scan_tier = (FUSED_COMPACT, DECIDE_SCAN, STREAMS * cfg.N_max)
    compact_kernels = ("packed_hamming_batched", "bank_prefix_hamming")
    tiers = set()
    for traffic, b, frames in (("served", base, served),
                               ("reuse", base_reuse, reuse)):
        seen, _ = phase_lowering(cfg, sys_, frames, report,
                                 f"compact, {traffic}", b, compact_kernels,
                                 (full_tier,), runs, fused="compact")
        tiers.update(e[2] for e in seen if e[0] == FUSED_COMPACT)
        phase_lowering(cfg, sys_, frames, report, f"compact scan, {traffic}",
                       b, ("bank_prefix_hamming", "delta_update"),
                       (scan_tier,), runs, fused="compact", decide="scan")
        seen, _ = phase_lowering(
            cfg, sys_, frames, report, f"auto, {traffic}", b,
            ("bank_prefix_hamming",), (prefix, compact), runs, fused="auto")
        tiers.update(e[2] for e in seen if e[0] == FUSED_COMPACT)
        if traffic == "reuse" and not any(e[0] == FUSED_COMPACT
                                          for e in seen):
            raise AssertionError("auto never reached the compact lowering "
                                 "on the reuse traffic")
    _prefix_tiers(cfg, im_cuda.packed, tiers, report, rates)
    done("lowerings (serial switch, compact, compact scan, auto)")
    phase_evaluate(cfg, world, sys_)
    done("evaluate")
    phase_sign_project(sys_, served, report)
    rows = phase_plans(cfg, sys_, served, reuse, runs)
    done("plan ladder")
    for check in cpu_checks:    # before the phases that time against RT-60
        check()
    done("the serving phase's CPU reference engines")
    phase_governed(cfg, sys_, reuse)
    done("governed (async)")
    async_rows = phase_async(cfg, sys_, (
        ("prefix, served", served, base[2], WINDOWS, "serve",
         ("bank_prefix_hamming",), {}),
        ("prefix, reuse", reuse, base_reuse[2], REUSE_WINDOWS,
         f"reuse, windows cut to K={cfg.K} proposals",
         ("bank_prefix_hamming",), {}),
        ("compact, served", served, base[2], WINDOWS, "compact, served",
         compact_kernels, dict(fused="compact")),
        ("compact, reuse", reuse, base_reuse[2], REUSE_WINDOWS,
         "compact, reuse", compact_kernels, dict(fused="compact")),
        ("serial switch, served", served, base[2], 1, None,
         ("fused_scores", "delta_update"), dict(serial=True))), runs)
    done("async == sync")
    phase_launcher()
    done("launcher")
    by_label = {r["label"]: r for r in runs}
    sup_rows = phase_supervised(
        cfg, sys_, reuse, base_reuse[2], by_label["compact, reuse"]["res"],
        base_reuse[0], next(r["async_ms_per_step"] for r in async_rows
                            if r["label"] == "compact, reuse"))
    done("supervised recovery")
    gw_rows = phase_gateway(cfg, sys_, reuse, base_reuse[2])
    done("gateway")
    fe_row = phase_front_end(report)
    done("front end (events, encoder, bridge trainer, reranker)")
    lm_row = phase_lm(report)
    done("LM serving")
    rec_row = phase_recurrent(report)
    done("recurrent families and int8 decode")
    train_row = phase_train(report)
    done("LM training")
    mesh_row = phase_mesh(report, cfg, sys_, served)
    done("mesh layer, dry-run and the 2x2 decode")
    stream_mesh_row = phase_stream_mesh(cfg, sys_, (
        ("prefix, served", served, base[2], {}, ("bank_prefix_hamming",)),
        ("prefix, reuse", reuse, base_reuse[2], {},
         ("bank_prefix_hamming",)),
        ("compact, served", served, base[2], dict(fused="compact"),
         compact_kernels),
        ("compact, reuse", reuse, base_reuse[2], dict(fused="compact"),
         compact_kernels)), report)
    done("stream-sharded engine")
    cards_row = phase_mesh_cards(report)
    done("the mesh on cards")
    phase_eager(runs)
    done("eager == captured")
    phase_plan_idle(cfg, sys_, served, rows)
    done("plan ladder idle share")
    missing = [n for n, r in report.items() if "launches" not in r]
    if missing:
        raise AssertionError(f"never launched on a path: {missing}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"plan_ladder": rows}))
    print(json.dumps({"async_vs_sync": async_rows}))
    print(json.dumps({"supervised": sup_rows}))
    print(json.dumps({"gateway": gw_rows}))
    print(json.dumps({"front_end": fe_row}))
    print(json.dumps({"lm_serving": lm_row}))
    print(json.dumps({"recurrent_int8": rec_row}))
    print(json.dumps({"lm_training": train_row}))
    print(json.dumps({"mesh": mesh_row}))
    print(json.dumps({"stream_mesh": stream_mesh_row}))
    print(json.dumps({"mesh_cards": cards_row}))
    print(json.dumps({"kernels": list(report.values())}))
    _result_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
