"""Launch counters of the CUDA kernels and call counters of their plain twins.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else; each plain version adds one to ``PLAIN_CALLS[name]`` when it
runs.  A caller resets them around a run to show which path it took.
"""

from __future__ import annotations

NAMES = ("spectrum", "eq6_normal_eq_v9", "spd_solve_damped", "spd_inverse_diag",
         "acme_polish", "spd_inverse_diag_dense", "spd_solve_damped_dense",
         "eq6_normal_eq_v3", "eq6_normal_eq_v5", "lm_loop_v10",
         "eq6_normal_eq_v8", "eq6_normal_eq_v7", "eq6_normal_eq_v6",
         "eq6_normal_eq_v2", "eq6_normal_eq_v1",
         # K1's dense route: plain PyTorch (a matmul), not a kernel
         "spectrum_dense")

LAUNCHES: dict[str, int] = {n: 0 for n in NAMES}
PLAIN_CALLS: dict[str, int] = {n: 0 for n in NAMES}


def reset() -> None:
    for n in NAMES:
        LAUNCHES[n] = 0
        PLAIN_CALLS[n] = 0


def snapshot() -> dict[str, dict[str, int]]:
    return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS)}
