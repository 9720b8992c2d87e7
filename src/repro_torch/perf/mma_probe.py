"""Probe the tensor-core routes for the hamming kernels' products.

    python -m repro_torch.perf.mma_probe

Builds ``perf/mma_probe.cu`` once per variant (int8 ``mma.sync`` on 0/1
bytes; the 1-bit ``mma.sync`` with ``.and.popc`` and ``.xor.popc`` on the
packed words; ``wgmma`` in int8 and in 1-bit ``.and.popc``), reports the
variants ``ptxas`` refuses, holds the 1-bit ``mma.sync`` fragments against
popc(a & b) and popc(a ^ b) on the host, and times each accepted variant
over the whole card (eight blocks an SM; 4 or 8 independent chains a
warp for ``mma.sync``, 2 or 4 a warpgroup for ``wgmma``)
and, for ``mma.sync``, the cycles of one product in a single dependent
chain. Prints one ``[probe]`` line per variant: word pairs
(a 32-bit word of one row against one of another: 32 bit products) per
second, and the same as int8 operations per second (64 a word pair, the
unit of the card's 1,979 TOP/s), beside the card's name and power limit.
Needs a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..core import hdc
from ..device import smi
from ..kernels import build

SRC = Path(__file__).resolve().parent / "mma_probe.cu"
VARIANTS = {
    1: "mma.sync m16n8k32 u8 (0/1 bytes)",
    2: "mma.sync m16n8k256 b1 .and.popc",
    3: "mma.sync m16n8k256 b1 .xor.popc",
    4: "wgmma m64n64k32 u8",
    5: "wgmma m64n64k256 b1 .and.popc",
}
ITERS = 4096


def compile_all() -> dict:
    """{variant: library path or the nvcc log of a refusal}, built in
    parallel."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        out = build.BUILD_DIR / f"mma_probe_{v}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DVARIANT={v}",
               "-o", str(out), str(SRC)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), out)
    res = {}
    for v, (p, out) in procs.items():
        log, _ = p.communicate()
        res[v] = (out if p.returncode == 0 else None, log)
    return res


def _fns(path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_rate_launch.argtypes = (I, I, I, P, P)
    lib.probe_check_launch.argtypes = (P, P, P, P)
    lib.probe_latency_launch.argtypes = (I, P, P, P)
    lib.probe_pairs_per_product.restype = ctypes.c_longlong
    return lib


def check(lib, op: str) -> bool:
    """One m16n8k256 product against popc(a op b) over eight words."""
    gen = torch.Generator().manual_seed(16)
    A = torch.randint(-2 ** 31, 2 ** 31 - 1, (16, 8), generator=gen,
                      dtype=torch.int32)
    B = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 8), generator=gen,
                      dtype=torch.int32)
    C = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
    Ad, Bd = A.cuda(), B.cuda()
    stream = torch.cuda.current_stream().cuda_stream
    if lib.probe_check_launch(Ad.data_ptr(), Bd.data_ptr(), C.data_ptr(),
                              stream) != 0:
        return False
    torch.cuda.synchronize()
    x = A[:, None, :] & B[None] if op == "and" else A[:, None, :] ^ B[None]
    want = hdc.popcount32(x).sum(-1, dtype=torch.int32)
    return torch.equal(C.cpu(), want)


def latency(lib) -> float:
    """Clock cycles of one product in a single warp's dependent chain."""
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    vals = []
    for iters in (64, 1088):   # the difference drops the fixed cost
        if lib.probe_latency_launch(iters, cyc.data_ptr(), out.data_ptr(),
                                    stream) != 0:
            raise RuntimeError("probe launch failed")
        torch.cuda.synchronize()
        vals.append(int(cyc.item()))
    return (vals[1] - vals[0]) / 1024


def rate(lib, sms: int, chains: int) -> float:
    """Word pairs per second over the whole card: 8 blocks an SM, each
    warp (warpgroup for wgmma) with ``chains`` products in flight."""
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    blocks = 8 * sms
    units = lib.probe_threads() // 32 if lib.probe_threads() == 256 else 1
    if lib.probe_rate_launch(blocks, 16, chains, out.data_ptr(),
                             stream) != 0:
        raise RuntimeError("probe launch failed")
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        lib.probe_rate_launch(blocks, ITERS, chains, out.data_ptr(), stream)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 1e3)
    t = sorted(times)[len(times) // 2]
    return blocks * units * ITERS * chains * lib.probe_pairs_per_product() / t


def probe(log=print) -> list:
    """Build, check and time every variant; log one ``[probe]`` line each
    and return the rows."""
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for v, (path, out) in compile_all().items():
        row = dict(variant=VARIANTS[v], card=card)
        if path is None:
            err = [ln for ln in out.splitlines() if "error" in ln.lower()]
            row.update(accepted=False, error=" | ".join(err[:3]))
            log(f"[probe] {VARIANTS[v]}: refused by nvcc/ptxas: "
                f"{row['error']}")
        else:
            lib = _fns(path)
            if v in (2, 3):
                row["layout_ok"] = check(lib, "and" if v == 2 else "xor")
            if v <= 3:
                row["latency_cycles"] = latency(lib)
            by_chains = {ch: rate(lib, sms, ch)
                         for ch in ((4, 8) if v <= 3 else (2, 4))}
            r = max(by_chains.values())
            row.update(accepted=True, word_pairs_per_s=r,
                       int8_equiv_ops_per_s=64 * r,
                       word_pairs_per_s_by_chains=by_chains)
            log(f"[probe] {VARIANTS[v]} ({card}): {r / 1e12:.2f} T word "
                f"pairs/s = {64 * r / 1e12:.0f} T int8-equivalent ops/s ("
                + ", ".join(f"{ch} chains a {'warp' if v <= 3 else 'warpgroup'}"
                            f" {x / 1e12:.2f} T" for ch, x in by_chains.items())
                + ")"
                + (f"; {row['latency_cycles']:.1f} cycles a dependent "
                   f"product" if "latency_cycles" in row else "")
                + (f"; fragment layout == popc on the host: "
                   f"{row['layout_ok']}" if "layout_ok" in row else ""))
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe needs a GPU")
    print(smi("name,power.limit"), flush=True)
    rows = probe(lambda *a: print(*a, flush=True))
    print(json.dumps({"probe": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
