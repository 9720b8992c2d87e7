"""Roofline terms of a dry-run cell (port of ``repro.perf.roofline``).

Target hardware: NVIDIA H100 SXM5 (NVIDIA's data sheet, dense rates):

    PEAK_FLOPS = 989e12   bf16 FLOP/s per card (the MFU figure of PERF.md)
    HBM_BW     = 3.35e12  bytes/s of HBM3 per card
    LINK_BW    = 450e9    bytes/s per card and direction over NVLink 4

The NVLink figure holds within one node of 8 cards; a 'model' axis wider
than 8 cards (the production mesh's 16) crosses nodes, over InfiniBand at
a fraction of it, so the collective term below is a lower bound there.

    compute term    = flops_global / (chips * PEAK_FLOPS)
    memory term     = bytes_global / (chips * HBM_BW)
    collective term = coll_bytes_global / (chips * LINK_BW)

``perf/op_analyze.py`` records one rank's ops (per-device figures); the
global terms are those times the number of cards, as the reference scales
its per-device cost analysis.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12       # bf16 / card, dense (H100 SXM5 data sheet)
HBM_BW = 3.35e12          # bytes/s / card (HBM3, H100 SXM5)
LINK_BW = 450e9           # bytes/s / card, each way (NVLink 4)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    coll_breakdown: dict
    model_flops: float
    memory_per_device: dict

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_global / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops_global if self.flops_global \
            else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the peak implied by the dominant term if compute-bound
        at the model's useful FLOPs: MODEL_FLOPS / (chips*peak) / t_bound."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "coll_bytes_global": self.coll_bytes_global,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "memory_per_device": self.memory_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def analyze(lowered, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float) -> Roofline:
    """Roofline terms of a lowered cell (``runtime.steps.lower_cell``): its
    ``analyze()`` runs the step once under ``op_analyze.OpAnalyzer``, on
    one rank's shards. ``memory_per_device`` holds ``argument_bytes`` (the
    local shards of parameters, optimizer state, batch and cache),
    ``output_bytes`` (the step's outputs that are not its donated
    arguments) and ``peak_bytes`` (the arguments plus the analyzer's
    high-water mark of live bytes)."""
    an = lowered.analyze()
    coll = dict(an.collective_bytes)
    counts = dict(an.collective_counts)
    counts["bytes_pessimistic_global"] = an.bytes_traffic_pessimistic * chips
    mem = {"argument_bytes": int(lowered.argument_bytes),
           "output_bytes": int(lowered.output_bytes),
           "peak_bytes": int(lowered.argument_bytes + an.peak_live_bytes)}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_global=an.flops * chips,
        bytes_global=an.bytes_traffic * chips,
        coll_bytes_global=an.total_collective_bytes() * chips,
        coll_breakdown={k: v * chips for k, v in coll.items()} | {
            "counts": counts},
        model_flops=model_flops,
        memory_per_device=mem,
    )


def model_flops_for(cfg, shape: dict) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.

    decode: D = global_batch (one token each). train: forward+backward = 6ND.
    prefill/decode (inference): 2*N*D forward-only.
    """
    n_active = cfg.active_param_count()
    tokens = shape["global_batch"] * (shape["seq_len"] if shape["mode"] in
                                      ("train", "prefill") else 1)
    mult = 6.0 if shape["mode"] == "train" else 2.0
    return mult * n_active * tokens
