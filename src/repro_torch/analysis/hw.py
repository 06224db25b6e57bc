"""GPU constants — the port's counterpart of ``repro/analysis/hw.py``.

``GpuChip`` replaces ``TpuChip``: what the kernels size themselves by (SM
count, the per-block opt-in shared memory) and what a roofline bound
divides by (memory bandwidth, FP32 peak outside the tensor cores, the
bf16 dense tensor-core peak, NVLink, the card's memory).  Bandwidth and
peaks are not device properties, so they come from NVIDIA's data sheets,
picked by the card's name; the memory is the card's ``total_memory``
where a card is present.

The paper-device table reproduces paper Table II verbatim, as the
reference's does: the devices the paper compares its Arria 10 with.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GpuChip:
    name: str
    sm_count: int
    smem_optin: int              # bytes of shared memory one block may use
    hbm_bytes_per_s: float
    peak_fp32_flops: float       # FP32 outside the tensor cores
    nvlink_bytes_per_s: float = 0.0  # to another card, each way
    peak_bf16_flops: float = 0.0     # dense bf16 on the tensor cores
    hbm_bytes: int = 0               # device memory

    @classmethod
    def from_device(cls, index: int = 0) -> "GpuChip":
        """The visible card's SM count and shared-memory limit, with the
        data-sheet bandwidth and peak for its name."""
        props = torch.cuda.get_device_properties(index)
        sheet = datasheet(props.name)
        return dataclasses.replace(
            sheet, name=props.name, sm_count=props.multi_processor_count,
            smem_optin=getattr(props, "shared_memory_per_block_optin",
                               sheet.smem_optin),
            hbm_bytes=props.total_memory)


#: NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 and
#: 989 TFLOP/s dense bf16 (700 W), 80 GB, NVLink 900 GB/s to the other
#: cards of the host (450 GB/s each way).
H100_SXM = GpuChip(name="NVIDIA H100 SXM", sm_count=132, smem_optin=232448,
                   hbm_bytes_per_s=3.35e12, peak_fp32_flops=67e12,
                   nvlink_bytes_per_s=450e9, peak_bf16_flops=989e12,
                   hbm_bytes=80_000_000_000)

#: NVIDIA H100 PCIe data sheet: 2.0 TB/s HBM2e, 51 TFLOP/s FP32 and 756
#: TFLOP/s dense bf16 (350 W), 80 GB, an NVLink bridge of 600 GB/s (300
#: GB/s each way).
H100_PCIE = GpuChip(name="NVIDIA H100 PCIe", sm_count=114, smem_optin=232448,
                    hbm_bytes_per_s=2.0e12, peak_fp32_flops=51e12,
                    nvlink_bytes_per_s=300e9, peak_bf16_flops=756e12,
                    hbm_bytes=80_000_000_000)


def datasheet(name: str) -> GpuChip:
    """Data-sheet figures for a card name as ``nvidia-smi`` or
    ``torch.cuda.get_device_name`` print it (PCIe parts by the word
    "PCIe", every other H100 as SXM)."""
    return H100_PCIE if "pcie" in name.lower() else H100_SXM



@dataclasses.dataclass(frozen=True)
class PaperDevice:
    """A row of paper Table II."""

    name: str
    peak_gflops: float          # single-precision
    mem_bw_gbps: float
    tdp_watt: float
    flop_per_byte: float


# Paper Table II, verbatim.
PAPER_DEVICES = {
    "arria10": PaperDevice("Arria 10 GX 1150", 1450.0, 34.1, 70.0, 42.522),
    "xeon": PaperDevice("Xeon E5-2650 v4", 700.0, 76.8, 105.0, 9.115),
    "xeonphi": PaperDevice("Xeon Phi 7210F", 5325.0, 400.0, 235.0, 13.313),
    "gtx580": PaperDevice("GTX 580", 1580.0, 192.4, 244.0, 8.212),
    "gtx980ti": PaperDevice("GTX 980 Ti", 6900.0, 336.6, 275.0, 20.499),
    "p100": PaperDevice("Tesla P100", 9300.0, 720.9, 250.0, 12.901),
}

ARRIA10_DSPS = 1518           # paper §V.A
ARRIA10_MEM_CTRL_MHZ = 266.0  # paper §VI.A
