"""The paper's performance model (eqs. 2, 4, 5, 6) and the H100 model's
GB/s — counterpart of ``repro/core/perf_model.py``.

The paper's FPGA model is copied with the reference's numbers: given a
Table III row's (f_max, par_vec, par_time, bsize, rad),
``paper_predicted_gbps`` gives its "Estimated Performance" column as

    GB/s = f * par_vec * 8 B * par_time * (csize_x / bsize_x)

:func:`predicted_gbps` is the port's own: the effective GB/s the H100
model (``core/blocking.estimate``) predicts for a plan, through the same
effective-bandwidth formula (:func:`gbps_from_cells_per_s`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.analysis.hw import GpuChip, H100_SXM
from repro_torch.core.program import StencilProgram, as_program

#: DSP blocks of the paper's Arria 10 GX 1150 (paper §V.A).
ARRIA10_DSPS = 1518


def flops_per_cell(ndim: int, rad: int) -> int:
    """Paper Table I FLOP/cell, derived by enumerating the star tap set
    (2*(2*ndim*rad) + 1 == 8*rad+1 in 2D, 12*rad+1 in 3D)."""
    return StencilProgram(ndim=ndim, radius=rad, shape="star").flops_per_cell


def bytes_per_cell() -> int:
    return 8  # f32 read + write at full reuse (paper Table I)


def csize(bsize: int, par_time: int, rad: int) -> int:
    """Paper eq. 2."""
    return bsize - 2 * (par_time * rad)


def par_total_dsps(ndim: int, rad: int, dsps: int = ARRIA10_DSPS) -> int:
    """Paper eq. 4: DSP budget per cell update -> total parallelism."""
    per_cell = (4 * rad + 1) if ndim == 2 else (6 * rad + 1)
    return dsps // per_cell


def constraint_eq5(par_time: int, par_vec: int, ndim: int, rad: int) -> bool:
    return par_time * par_vec <= par_total_dsps(ndim, rad)


def constraint_eq6(par_time: int, rad: int) -> bool:
    """Paper eq. 6: external-memory alignment restriction."""
    return (par_time * rad) % 4 == 0


def gbps_from_cells_per_s(cells_per_s: float,
                          cell_bytes: Optional[int] = None) -> float:
    """Effective GB/s from useful cell-updates/s: one read + one write per
    useful cell update (Table I), however the device achieved it."""
    if cell_bytes is None:
        cell_bytes = bytes_per_cell()
    return cells_per_s * cell_bytes / 1e9


def paper_predicted_gbps(f_mhz: float, par_vec: int, par_time: int,
                         bsize_x: int, rad: int) -> float:
    """Effective GB/s predicted for a configuration (module docstring)."""
    cs = csize(bsize_x, par_time, rad)
    if cs <= 0:
        return 0.0
    cells_per_s = f_mhz * 1e6 * par_vec * par_time * (cs / bsize_x)
    return gbps_from_cells_per_s(cells_per_s)


def predicted_gbps(program: StencilProgram, plan, chip: GpuChip = H100_SXM,
                   variant: Optional[str] = None) -> float:
    """Effective GB/s the H100 model predicts for ``plan`` under
    ``variant``: the useful cell updates per second of one superstep's
    kernel (``blocking.estimate``) through :func:`gbps_from_cells_per_s`.
    Accepts a legacy ``StencilSpec`` for ``program``."""
    # local: core/blocking imports the kernels, which import this package
    from repro_torch.core.blocking import estimate
    return gbps_from_cells_per_s(
        estimate(plan, chip, variant).gcells_per_s * 1e9,
        cell_bytes=as_program(program).bytes_per_cell)


def gbps_to_gcells(gbps: float) -> float:
    return gbps / bytes_per_cell()


def gcells_to_gflops(gcells: float, ndim: int, rad: int) -> float:
    return gcells * flops_per_cell(ndim, rad)


def roofline_ratio(achieved_gbps: float, device_mem_bw_gbps: float) -> float:
    """Paper Tables IV/V 'Roofline Ratio': effective vs naive-bandwidth
    bound."""
    return achieved_gbps / device_mem_bw_gbps


@dataclasses.dataclass(frozen=True)
class FpgaConfig:
    """One paper Table III row's tunables."""

    ndim: int
    rad: int
    bsize: Tuple[int, ...]
    par_vec: int
    par_time: int
    f_mhz: float

    def predicted_gbps(self) -> float:
        return paper_predicted_gbps(self.f_mhz, self.par_vec, self.par_time,
                                    self.bsize[0], self.rad)


def enumerate_fpga_configs(ndim: int, rad: int, f_mhz: float,
                           bsizes: Sequence[Tuple[int, ...]],
                           max_par_time: int = 64) -> list:
    """The paper's §V.A parameter sweep: all (par_vec, par_time) satisfying
    eqs. 4/5/6, ranked by predicted throughput."""
    out = []
    for bsize in bsizes:
        for par_vec in (2, 4, 8, 16, 32):
            for par_time in range(1, max_par_time + 1):
                if not constraint_eq5(par_time, par_vec, ndim, rad):
                    continue
                if not constraint_eq6(par_time, rad):
                    continue
                if csize(bsize[0], par_time, rad) <= 0:
                    continue
                out.append(FpgaConfig(ndim, rad, tuple(bsize), par_vec,
                                      par_time, f_mhz))
    out.sort(key=lambda c: c.predicted_gbps(), reverse=True)
    return out


# ---- paper Table III rows (ground truth for validation) --------------------

@dataclasses.dataclass(frozen=True)
class PaperRow:
    ndim: int
    rad: int
    bsize: Tuple[int, ...]
    par_vec: int
    par_time: int
    input_size: Tuple[int, ...]
    estimated_gbps: float
    measured_gbps: float
    measured_gflops: float
    measured_gcells: float
    f_mhz: float
    power_watt: float
    model_accuracy: float  # measured/estimated, as printed


PAPER_TABLE3 = [
    PaperRow(2, 1, (4096,), 8, 36, (16096, 16096), 780.500, 673.959, 758.204, 84.245, 343.76, 72.530, 0.863),
    PaperRow(2, 2, (4096,), 4, 42, (15712, 15712), 423.173, 359.752, 764.473, 44.969, 322.47, 69.611, 0.850),
    PaperRow(2, 3, (4096,), 4, 28, (15712, 15712), 264.863, 225.215, 703.797, 28.152, 302.75, 66.139, 0.850),
    PaperRow(2, 4, (4096,), 4, 22, (15680, 15680), 206.061, 174.381, 719.322, 21.798, 301.20, 68.925, 0.846),
    PaperRow(3, 1, (256, 256), 16, 12, (696, 696, 696), 378.345, 230.568, 374.673, 28.821, 286.61, 71.628, 0.609),
    PaperRow(3, 2, (256, 128), 16, 6, (696, 728, 696), 176.713, 97.035, 303.234, 12.129, 262.88, 59.664, 0.549),
    PaperRow(3, 3, (256, 128), 16, 4, (696, 728, 696), 114.667, 63.737, 294.784, 7.967, 255.36, 63.183, 0.556),
    PaperRow(3, 4, (256, 128), 16, 3, (696, 728, 696), 81.597, 44.701, 273.794, 5.588, 242.77, 58.572, 0.548),
]
