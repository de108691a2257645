"""Roofline terms of a dry-run step on the H100 (``repro.roofline.analysis``
in PyTorch).

    compute    = op FLOPs / (chips * 989e12)     [dense bf16, H100 SXM]
    memory     = op bytes / (chips * 3.35e12)    [HBM3]
    collective = collective bytes / (chips * 450e9)   [NVLink, one way]

The FLOPs, bytes and collective bytes are the op walker's
(``roofline.op_walk``): the eager port's own kernels, counted on meta
tensors, and on a production mesh one device's program under DTensor
times the chips (``launch.dryrun``).  The collective term is 0 on one
card.  ``LINK_BW`` is one rate, as the reference's ``ICI_BW`` is: 450
GB/s is a GPU's NVLink rate inside one 8-GPU NVLink domain, and a
16-wide ``"model"`` axis spans two such nodes, whose link is slower;
no per-axis rate is modelled.  ``model_flops`` (6·N·D train, 2·N·D
forward and decode, N the active parameters) gives the usefulness
ratio, as in the reference.  The rates are NVIDIA's H100 SXM data sheet
values.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12      # dense bf16 tensor cores / chip
HBM_BW = 3.35e12         # bytes/s / chip
LINK_BW = 450e9          # NVLink 4, bytes/s / chip, one direction


@dataclasses.dataclass
class Roofline:
    name: str
    mesh: str
    chips: int
    hlo_flops: float             # the op walker's FLOPs (the key is the
    hlo_bytes: float             # reference's), summed over the chips
    coll_bytes: float            # summed over the chips
    model_flops: float
    bytes_per_chip: float        # argument + temp peak, one device

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def usefulness(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    def row(self) -> dict:
        return {
            "name": self.name, "mesh": self.mesh, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "usefulness": self.usefulness,
            "hbm_per_chip_gb": self.bytes_per_chip / 1e9,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D (train), 2·N·D (forward/decode) with N = active params."""
    pc = cfg.param_count()
    n_active = pc["active"]
    # enc-dec: each token passes the encoder OR the decoder, and the
    # train-seq budget is split between frames and tokens -> halve.
    encdec = 0.5 if cfg.enc_dec else 1.0
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * encdec
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per request
    return 2.0 * n_active * shape.global_batch


def memory_record(argument_bytes: float, output_bytes: float,
                  temp_bytes: float) -> dict:
    """The dry run's per-device memory (the counterpart of the
    reference's ``memory_analysis`` fields): the step's arguments (from
    the sharding specs), the outputs it creates, and the most bytes its
    own storages held at once (outputs included); ``peak_gb`` is
    arguments + temp."""
    return {"argument_gb": argument_bytes / 1e9,
            "output_gb": output_bytes / 1e9,
            "temp_gb": temp_bytes / 1e9,
            "peak_gb": (argument_bytes + temp_bytes) / 1e9}
