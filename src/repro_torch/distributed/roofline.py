"""Roofline terms of a per-device step on the NVIDIA H100: the port's
counterpart of the JAX package's ``repro/distributed/hlo_analysis.py``
(whose constants are a TPU's; none of them appears here).

Hardware model: NVIDIA's H100 SXM data sheet (the card "NVIDIA H100 80GB
HBM3, 700 W"), dense rates without sparsity:

* ``PEAK_FLOPS`` 989 TFLOP/s bf16 on the tensor cores;
* ``HBM_BW`` 3.35 TB/s;
* the link of the slowest hop each mesh axis crosses (``LINK_BW``):
  NVLink 4 within an 8-card node, 450 GB/s a direction (900 GB/s
  bidirectional), and the inter-node fabric beyond it, one 400 Gb/s
  InfiniBand NDR port a card, 50 GB/s.

An axis crosses nodes when its span in the mesh (its size times the
islands that vary faster than it) exceeds 8 cards: on the production
(16, 16) mesh the 16-wide ``model`` axis already spans two nodes and
``data`` spans 256 cards, so the collective term divides by the fabric's
50 GB/s.  ``roofline_terms`` takes the slowest link of the mesh's axes
unless told which one.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12  # bytes/s, HBM3, H100 SXM data sheet
NVLINK_BW = 450e9  # bytes/s a direction, NVLink 4 (18 links), H100 SXM data sheet
FABRIC_BW = 50e9  # bytes/s, one 400 Gb/s InfiniBand NDR port a card
NODE_CARDS = 8  # cards an NVLink domain joins (HGX H100 8-GPU)


def axis_link_bw(mesh) -> dict[str, float]:
    """Per mesh axis, the bandwidth of the slowest link a collective over
    it crosses: NVLink while its span fits one node, the fabric beyond."""
    out = {}
    span = 1
    for name in reversed(mesh.axis_names):
        n = mesh.shape[name]
        span *= n
        out[name] = NVLINK_BW if span <= NODE_CARDS else FABRIC_BW
    return out


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    *,
    link_bw: float = FABRIC_BW,
) -> dict:
    """The three per-step roofline terms, in seconds (per-device program)."""
    t_compute = flops_per_device / PEAK_FLOPS
    t_memory = hbm_bytes_per_device / HBM_BW
    t_collective = collective_bytes_per_device / link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["roofline_fraction"] = (t_compute / bound) if bound > 0 else 0.0
    return terms


def model_flops_per_token(n_params_active: int) -> float:
    """6 N D rule: returns 6 * N (multiply by tokens for the step total)."""
    return 6.0 * n_params_active
