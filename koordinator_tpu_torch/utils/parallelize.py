"""Bounded parallel map: analog of reference `pkg/util/parallelize/parallelize.go`.

The reference fans Filter/Score out over nodes with a bounded goroutine pool. In the
TPU rebuild the hot fan-out is replaced by batched tensors; this helper remains for
host-side control work (informer callbacks, per-node controller reconciles) where
thread parallelism still applies (I/O bound).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

DEFAULT_PARALLELISM = 16


def parallelize_until(
    pieces: int, do_work: Callable[[int], None], parallelism: int = DEFAULT_PARALLELISM
) -> None:
    """Run do_work(i) for i in [0, pieces) on a bounded pool (errors propagate)."""
    if pieces <= 0:
        return
    workers = min(parallelism, pieces)
    if workers <= 1:
        for i in range(pieces):
            do_work(i)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for f in [pool.submit(do_work, i) for i in range(pieces)]:
            f.result()


def parallel_map(
    items: Sequence[T],
    fn: Callable[[T], R],
    parallelism: int = DEFAULT_PARALLELISM,
) -> List[R]:
    out: List[R] = [None] * len(items)  # type: ignore[list-item]

    def work(i: int) -> None:
        out[i] = fn(items[i])

    parallelize_until(len(items), work, parallelism)
    return out
