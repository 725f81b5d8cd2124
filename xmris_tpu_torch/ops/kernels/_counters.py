"""Launch counters of the CUDA kernels and call counters of their plain twins.

Each wrapper calls :func:`launched` where it launches its kernel and
nowhere else; each plain version calls :func:`plain_called` when it runs.
A caller resets them around a run to show which path it took.  The
counts are taken under a lock: the shards of a mesh launch from several
threads at once.
"""

from __future__ import annotations

import threading

NAMES = ("spectrum", "eq6_normal_eq_v9", "spd_solve_damped", "spd_inverse_diag",
         "acme_polish", "spd_inverse_diag_dense", "spd_solve_damped_dense",
         "eq6_normal_eq_v3", "eq6_normal_eq_v5", "lm_loop_v10",
         "eq6_normal_eq_v8", "eq6_normal_eq_v7", "eq6_normal_eq_v6",
         "eq6_normal_eq_v2", "eq6_normal_eq_v1", "acme_search",
         # K1's dense route: plain PyTorch (a matmul), not a kernel
         "spectrum_dense")

LAUNCHES: dict[str, int] = {n: 0 for n in NAMES}
PLAIN_CALLS: dict[str, int] = {n: 0 for n in NAMES}
_LOCK = threading.Lock()


def launched(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def plain_called(name: str) -> None:
    with _LOCK:
        PLAIN_CALLS[name] += 1


def reset() -> None:
    with _LOCK:
        for n in NAMES:
            LAUNCHES[n] = 0
            PLAIN_CALLS[n] = 0


def snapshot() -> dict[str, dict[str, int]]:
    with _LOCK:
        return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS)}
