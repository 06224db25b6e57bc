"""The paper's performance model (eqs. 2, 4, 5, 6) and the H100 model's
GB/s — counterpart of ``repro/core/perf_model.py``.

The paper's FPGA model is copied with the reference's numbers: given a
Table III row's (f_max, par_vec, par_time, bsize, rad),
``paper_predicted_gbps`` gives its "Estimated Performance" column as

    GB/s = f * par_vec * 8 B * par_time * (csize_x / bsize_x)

:func:`predicted_gbps` is the port's own: the effective GB/s the H100
model (``core/blocking.estimate``) predicts for a plan, through the same
effective-bandwidth formula (:func:`gbps_from_cells_per_s`).

``PAPER_TABLE3``, ``PAPER_TABLE4_2D`` and ``PAPER_TABLE5_3D`` are the
paper's own rows, verbatim (its Arria 10, Xeon, Xeon Phi and GPUs; never
the port's numbers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.analysis.hw import ARRIA10_DSPS, GpuChip, H100_SXM
from repro_torch.core.program import StencilProgram, as_program


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

# Paper Tables IV/V, verbatim: each device's measured GFLOP/s, GCell/s,
# GFLOP/s per watt and roofline ratio (the paper's arithmetic:
# ``roofline_ratio`` of the effective GB/s over Table II's bandwidth).
PAPER_TABLE4_2D = {
    # device: {rad: (gflops, gcells, gflops_per_watt, roofline_ratio)}
    "arria10": {1: (758.204, 84.245, 10.454, 19.76), 2: (764.473, 44.969, 10.982, 10.55),
                3: (703.797, 28.152, 10.641, 6.60), 4: (719.322, 21.798, 10.436, 5.11)},
    "xeon": {1: (45.306, 5.034, 0.521, 0.52), 2: (85.255, 5.015, 0.942, 0.52),
             3: (124.500, 4.980, 1.331, 0.52), 4: (165.231, 5.007, 1.737, 0.52)},
    "xeonphi": {1: (222.804, 24.756, 1.000, 0.50), 2: (398.735, 23.455, 1.774, 0.47),
                3: (592.250, 23.690, 2.629, 0.47), 4: (759.198, 23.006, 3.369, 0.46)},
}

PAPER_TABLE5_3D = {
    "arria10": {1: (374.673, 28.821, 5.231, 6.76), 2: (303.234, 12.129, 5.082, 2.85),
                3: (294.784, 7.967, 4.666, 1.87), 4: (273.794, 5.588, 4.674, 1.31)},
    "xeon": {1: (61.282, 4.714, 0.686, 0.49), 2: (115.225, 4.609, 1.235, 0.48),
             3: (151.996, 4.108, 1.617, 0.43), 4: (205.751, 4.199, 2.069, 0.44)},
    "xeonphi": {1: (288.990, 22.230, 1.279, 0.44), 2: (549.300, 21.972, 2.428, 0.44),
                3: (788.544, 21.312, 3.480, 0.43), 4: (1069.278, 21.822, 4.714, 0.44)},
    "gtx580": {1: (224.822, 17.294, 1.229, 0.72), 2: (358.725, 14.349, 1.960, 0.60),
               3: (404.928, 10.944, 2.213, 0.46), 4: (453.446, 9.254, 2.478, 0.38)},
    "gtx980ti": {1: (393.322, 30.256, 1.907, 0.72), 2: (627.582, 25.103, 3.043, 0.60),
                 3: (708.414, 19.146, 3.435, 0.46), 4: (793.295, 16.190, 3.846, 0.38)},
    "p100": {1: (842.381, 64.799, 4.493, 0.72), 2: (1344.100, 53.764, 7.169, 0.60),
             3: (1517.217, 41.006, 8.092, 0.46), 4: (1699.008, 34.674, 9.061, 0.38)},
}
