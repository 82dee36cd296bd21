"""Global memory budget (the reference's --memory / -m flag).

The reference turns -m into a hard RLIMIT_AS cap
(utils/memory_limit.hpp:14 limit_memory, spades.py:239 default 250 GB)
and sizes its disk-bucket counts from it. Here the budget is not a
setrlimit cap (a JAX GPU client reserves large virtual mappings up
front, which a hard AS cap would kill); it instead SIZES the streaming
knobs: how many reads a counting / correction / mapping chunk holds —
the dominant scalers of both HBM working sets and host RSS — and the
device-table cap past which hammer falls back to its spill path. The
defaults without a budget (2^20-read count chunks, a 2^24-row hammer
table) only bound sizes from above.
StageManager warns when a stage's peak RSS exceeds the budget.

Set once by the CLI (cli.py --memory); consumers call the sizing
helpers, which return their caller's default when no budget is set.
"""

from __future__ import annotations

import os

_budget_gb: float | None = None


def set_budget_gb(gb: float | None) -> None:
    global _budget_gb
    _budget_gb = float(gb) if gb else None


def get_budget_gb() -> float | None:
    if _budget_gb is not None:
        return _budget_gb
    env = os.environ.get("SFB_MEMORY_GB")
    return float(env) if env else None


def _pow2_below(n: int, lo: int, hi: int) -> int:
    n = max(lo, min(hi, n))
    return 1 << (n.bit_length() - 1)


def count_chunk_reads(default: int, read_len: int = 100) -> int:
    """Reads per key-counting chunk.

    Working set per read ~ P x (2-word key + instance idx + sort
    temps) ~ 2.5 KB at L=100; budget a quarter of the cap for it.
    """
    gb = get_budget_gb()
    if gb is None:
        return default
    per_read = max(read_len, 1) * 25
    return min(default, _pow2_below(int(gb * (1 << 30) / 4 / per_read),
                                    1 << 12, 1 << 22))


def stats_chunk_reads(default: int, read_len: int = 100,
                      k: int = 21) -> int:
    """Reads per quality-stats chunk: the (R*P, k) float quality
    matrix dominates (~ P x k x 8 bytes per read)."""
    gb = get_budget_gb()
    if gb is None:
        return default
    per_read = max(read_len, 1) * max(k, 1) * 8
    return min(default, _pow2_below(int(gb * (1 << 30) / 4 / per_read),
                                    1 << 10, 1 << 18))


def device_cap_rows(default: int, k: int = 21) -> int:
    """Unique-table rows before hammer's host-spill fallback: the
    (U, k) float accumulator is the HBM peak (~ 4k bytes per row)."""
    gb = get_budget_gb()
    if gb is None:
        return default
    return min(default, _pow2_below(int(gb * (1 << 30) / 2 / (4 * k)),
                                    1 << 16, 1 << 28))
