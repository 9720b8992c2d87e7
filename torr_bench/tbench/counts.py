"""The yardstick's arithmetic: the chip's published peaks, the operations
and bytes of each hand-written kernel's call from its own shapes, and the
least time a window's required work needs.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at the full
700 W: 495 TFLOP/s in TF32, 3.35 TB/s of HBM3. The 1-bit tensor-core
product (the hamming kernels' route) has no published H100 rate, so those
kernels are bounded by their bytes alone.

A call's bytes count each input tensor read once and each output written
once, from the shapes the kernel was launched with (``launch_bytes``).
"""
from __future__ import annotations

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

# kernel name -> the names of its device functions
DEVICE_FUNCTIONS = {
    "sign_project_pack": ("sign_wgmma_kernel", "sign_mma_kernel"),
    "bank_prefix_hamming": ("bank_prefix_hamming_kernel",),
}


def launch_bytes(args: tuple) -> int:
    """Bytes of one launch: every tensor argument once (``args`` holds
    (numel, element size) pairs for tensors and ints for the rest)."""
    return sum(a[0] * a[1] for a in args if isinstance(a, tuple))


def launch_flops(name: str, args: tuple) -> int:
    """Operations of one launch at a published peak: the encode's one
    product of z [N, d] and R [D, d] (2 N d D); none for the hamming
    kernels, whose 1-bit product has no published peak."""
    if name == "sign_project_pack":
        N, d, D = args[3], args[4], args[5]
        return 2 * N * d * D
    return 0


def bound_s(name: str, args: tuple) -> float:
    """The least time of one launch: the larger of its operations at the
    TF32 peak and its bytes at the HBM peak."""
    return max(launch_flops(name, args) / PEAK_TF32_FLOPS,
               launch_bytes(args) / PEAK_HBM_BYTES)


def window_required(tc: dict, n_valid: int, n_full: int,
                    delta_counts) -> tuple[float, float]:
    """(operations, bytes) one window requires: one TF32 encode of its
    valid proposals; the item memory's words and each full-path query's
    words read by the full scan, and its scores written; each delta
    proposal's flipped item-memory rows read and its accumulator row read
    and written. The item memory is counted per step by the caller."""
    D, M, d = tc["D"], tc["M"], tc["feat_dim"]
    flops = 2 * n_valid * d * D
    nbytes = n_valid * (d * 4 + D // 8)                  # z in, q out
    nbytes += n_full * (D // 8 + M * 4)                  # query, scores
    for k in delta_counts:
        nbytes += int(k) * M + 2 * M * 4                 # dmajor rows, acc
    return flops, nbytes


def item_memory_bytes(tc: dict) -> int:
    """The packed item memory and the projection R, read once a step."""
    return tc["M"] * tc["D"] // 8 + tc["D"] * tc["feat_dim"] * 4
