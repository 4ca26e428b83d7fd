"""Degree-balanced schedule of CSR rows for the row kernels.

A kernel that gives every row one warp lets the widest row set the time of
the launch: at RMAT-18 one row holds 25,196 entries, which one warp walks
in 788 dependent steps while the rest of the card sits idle, and the many
short or empty rows leave most lanes idle. The schedule classes the rows
of a CSR by length d = indptr[v + 1] - indptr[v]:

  * narrow rows, d <= NARROW (empty rows included): one thread a row, 32
    rows a warp, each thread walking its row in order;
  * every other row is cut into segments of at most SEGMENT entries, one
    warp a segment, the lanes striding it. A row of one segment (a middle
    row) is finished by its warp; a row of several (a wide row) leaves one
    partial a segment, which a finish pass combines, a warp a wide row, its
    lanes striding the partials and a shuffle tree adding the lanes' sums
    (K32); where the combination is exact in any order, a kernel may fold a
    wide row's segments with atomics instead (K25's and K33's minimum).

So no warp walks more than max(32 NARROW, SEGMENT) = 512 entries, whatever
the widest row, and a float sum over the schedule runs in one fixed order
(lane-strided sums, then a shuffle tree): it gives the same bits on every
run. The schedule is built
once per call with torch ops on indptr's device (a few host syncs, for
the list sizes) and serves every iteration or step of that call.

Device side: csrc/row_schedule.cuh, which reads the two buffers below.
Kernels on it: K32 pr_pull (csrc/gapbs_pr.cu), K25 component_step
(csrc/color_components.cu) and K33 cc_step / sssp_step (csrc/gapbs_min.cu),
which share the min step of csrc/min_step.cuh, and K34 bc_forward / bc_backward
(csrc/gapbs_bc.cu), which gives every narrow row a warp (its lanes are a
batch's sources, not the row's entries) and a wide row's segments float64
partials for each source.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NARROW = 8       # a row of at most this many entries takes one thread
SEGMENT = 512    # entries of a segment, one warp each


@dataclass(frozen=True, eq=False)
class RowSchedule:
    """The schedule of the n rows of one CSR, kept with `indptr`, the
    tensor it was built from (a kernel takes it only with that tensor), in
    two buffers:

    rows:   int32[n_narrow + n_seg + n_wide], three lists end to end:
            narrow, the rows with d <= NARROW, ascending; seg_row, the row
            of each segment, ascending (a row's segments consecutive);
            wide_row, the rows of more than one segment, ascending;
    starts: int64[n_seg + n_wide]: seg_start, the first entry of each
            segment (a segment ends SEGMENT entries on or at its row's
            end); wide_seg, the index of each wide row's first segment.
    """

    indptr: torch.Tensor
    n: int
    n_narrow: int
    n_seg: int
    n_wide: int
    rows: torch.Tensor
    starts: torch.Tensor

    @property
    def narrow(self) -> torch.Tensor:
        return self.rows[:self.n_narrow]

    @property
    def seg_row(self) -> torch.Tensor:
        return self.rows[self.n_narrow:self.n_narrow + self.n_seg]

    @property
    def wide_row(self) -> torch.Tensor:
        return self.rows[self.n_narrow + self.n_seg:]

    @property
    def seg_start(self) -> torch.Tensor:
        return self.starts[:self.n_seg]

    @property
    def wide_seg(self) -> torch.Tensor:
        return self.starts[self.n_seg:]

    def launch_args(self) -> tuple:
        """The C entries' schedule arguments: rows, starts, n_narrow,
        n_seg, n_wide, SEGMENT."""
        return (self.rows, self.starts, self.n_narrow, self.n_seg,
                self.n_wide, SEGMENT)


def build_row_schedule(indptr: torch.Tensor) -> RowSchedule:
    """The schedule of the CSR rows of `indptr` (int64[n + 1]), on its
    device."""
    if indptr.dtype != torch.int64 or indptr.dim() != 1 or indptr.numel() < 1:
        raise TypeError(f"build_row_schedule: indptr must be int64[n + 1], "
                        f"got {indptr.dtype} {tuple(indptr.shape)}")
    deg = indptr.diff()
    short = deg <= NARROW
    narrow = torch.nonzero(short).flatten()
    rows = torch.nonzero(~short).flatten()
    nseg = (deg[rows] + SEGMENT - 1) // SEGMENT
    first = torch.cumsum(nseg, 0) - nseg
    n_seg = int(nseg.sum())
    seg_row = torch.repeat_interleave(rows, nseg, output_size=n_seg)
    within = (torch.arange(n_seg, device=indptr.device)
              - torch.repeat_interleave(first, nseg, output_size=n_seg))
    wide = nseg > 1
    wide_row = rows[wide]
    return RowSchedule(
        indptr=indptr, n=indptr.numel() - 1, n_narrow=narrow.numel(), n_seg=n_seg,
        n_wide=wide_row.numel(),
        rows=torch.cat([narrow, seg_row, wide_row]).to(torch.int32),
        starts=torch.cat([indptr[seg_row] + within * SEGMENT, first[wide]]))


def check_schedule(name: str, schedule: RowSchedule,
                   indptr: torch.Tensor) -> None:
    """Raise unless `schedule` is the RowSchedule built from this very
    `indptr` tensor: another CSR's schedule, even of as many rows, would
    send the kernels to its offsets (an identity test, no sync)."""
    if not isinstance(schedule, RowSchedule):
        raise TypeError(f"{name}: schedule must be a RowSchedule, got "
                        f"{type(schedule).__name__}")
    if schedule.indptr is not indptr:
        raise ValueError(f"{name}: schedule built from another indptr "
                         f"({schedule.n} rows; this one has "
                         f"{indptr.shape[0] - 1})")
