"""The yardstick of the SW kernels' roofline share.

Work: DP cells times the integer operations one cell of the affine-gap
local recurrence needs at the least, whatever kernel computes it:

    G = H - open             1 subtraction, once a cell: it serves both
                             E of the cell to the right and F of the
                             cell below
    E = max(E_left - extend, G_left)              1 subtraction, 1 max
    F = max(F_up - extend, G_up)                  1 subtraction, 1 max
    H = max(0, H_diag + s, E, F)                  1 addition, 3 max
    best = max(best, H)                           1 max

10 operations for the sequence search's cell, whose score s is one
lookup of the query's profile row; 11 for the structure search's, which
adds its 3Di and amino-acid channels (a second lookup and an addition).

Peak: the card's SM count (read from the device) x 64 int32 lanes an SM
x the published 1.98 GHz boost clock of the H100 SXM (132 SMs: 16.7 T
operations a second).  The kernels are bound by these operations, not by
bytes: a pair reads its two sequences once (a few hundred bytes) for
q_len x t_len cells.  The bound counts one operation a lane a clock: an
instruction that fuses two (Hopper's DPX max-plus forms) is counted as
the two it does.
"""

OPS_PER_CELL = {"seq": 10, "struct": 11}
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9


def peak_ops_per_s(sm_count: int) -> float:
    return sm_count * INT32_LANES_PER_SM * BOOST_HZ


def least_seconds(cells: int, kind: str, sm_count: int) -> float:
    return cells * OPS_PER_CELL[kind] / peak_ops_per_s(sm_count)
