"""Roofline terms of a measured piece of work (port of
``repro.roofline.analysis``).

    compute term    = flops / peak FLOP/s
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / interconnect bandwidth

The reference reads flops and bytes from XLA's cost analysis of a
compiled executable; the port counts them as the work runs
(:mod:`repro_torch.roofline.solver`). Peaks are the published data-sheet
numbers of the card; a card set below its full power limit runs slower
than they say, so every reading names the card and its limit beside it.

The reference's ``collective_bytes`` parses XLA HLO text for collective
ops. The port's counterpart, :func:`collective_bytes`, takes the
collectives a traced step issued: DTensor's redistributions run as
``_c10d_functional`` ops, which
``repro_torch.roofline.solver.LocalWorkCounter`` records with their
result's bytes (the reference's rule: the tensor that crosses the
interconnect once per op under a bandwidth-optimal ring; an all-reduce
moves about twice that), and the port's own collectives
(``repro_torch.core.dist``), which count what each rank sends
(``count_collective_bytes``): 0 for one card's replicated round, each
rank's own bytes for the sharded round over ``torch.distributed``, held
against ``ici_bw``.

``ici_bw`` is one H100's NVLink rate. A model axis of 16 spans two
8-card nodes, whose link between them is slower, so the collective term
it gives is a floor there, not an estimate.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card peaks (the reference's fields). ``name`` is the name
    ``nvidia-smi`` and ``torch.cuda.get_device_name`` report for the
    card."""
    name: str = "NVIDIA H100 80GB HBM3"
    peak_flops: float = 989e12      # dense bf16 FLOP/s (H100 SXM5)
    hbm_bw: float = 3.35e12         # HBM3 bytes/s
    ici_bw: float = 450e9           # NVLink 4 bytes/s, one direction
    hbm_bytes: float = 80e9         # HBM capacity


HW = Hardware()     # the default: one H100 SXM5 (80 GB HBM3)

# The same card's dense peaks of its other pipes, for work that does not
# run in bf16 on the tensor cores (``Hardware.peak_flops`` is the bf16
# rate, which the reference's fields carry alone).
FP32_FLOPS = 67e12      # float32 outside the tensor cores
TF32_FLOPS = 495e12     # TF32 on the tensor cores


COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast")

# ``_c10d_functional`` op -> the reference's kind of collective
C10D_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def collective_bytes(issued, explicit_bytes: int = 0) -> dict:
    """Per-kind byte totals of the collectives a step issued: ``issued``
    = (kind, result bytes) pairs (an all-reduce counted twice, as the
    reference counts it); ``explicit_bytes`` = what the port's own
    collectives sent, under "explicit". Every kind has a key, and
    "total" sums them."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, n in issued:
        out[kind] += int(n * (2 if kind == "all-reduce" else 1))
    out["explicit"] = int(explicit_bytes)
    out["total"] = sum(out.values())
    return out


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   hw: Hardware = HW) -> dict:
    compute_s = flops / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = coll_bytes / hw.ici_bw
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s}


def dominant_term(terms: dict) -> str:
    keys = ("compute_s", "memory_s", "collective_s")
    return max(keys, key=lambda k: terms[k]).replace("_s", "")


def step_time_estimate(terms: dict, overlap: bool = True) -> float:
    """Roofline step time: the max of the three terms when compute,
    memory and collectives overlap, their sum when they serialise."""
    vals = (terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return max(vals) if overlap else sum(vals)


def roofline_fraction(model_flops_per_device: float, terms: dict,
                      hw: Hardware = HW) -> float:
    """Fraction of peak the step achieves under the roofline estimate:
    useful-FLOPs time / estimated step time."""
    t = step_time_estimate(terms)
    if t <= 0:
        return 0.0
    return (model_flops_per_device / hw.peak_flops) / t
