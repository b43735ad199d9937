"""Probability-weighted dataset interleaving with `all_exhausted` semantics.

A copy of ``coral_tpu/data/interleave.py``: the port imports nothing of
``coral_tpu``.

Reimplements the behaviour the reference gets from HF's ``interleave_datasets``
(reference: ``src/coral/data.py:236-242``): draw the next source according to the
given probabilities; with the ``all_exhausted`` stopping strategy, exhausted
sources restart (oversampling) and iteration stops once every source has been
exhausted at least once. Deterministic for a given seed, so every host draws the
identical sample order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

import numpy as np


def interleave_iterables(
    make_iterators: list[Callable[[], Iterable[Any]]],
    probabilities: list[float] | None = None,
    seed: int = 0,
    stopping_strategy: str = "all_exhausted",
) -> Iterator[Any]:
    """Interleave several restartable sources.

    Args:
        make_iterators: One zero-arg factory per source (restartable).
        probabilities: Sampling probability per source; None = uniform.
        seed: Seed for the source-selection RNG.
        stopping_strategy: "all_exhausted" (restart + stop when all have finished
            once) or "first_exhausted" (stop at the first exhaustion).

    Yields:
        Examples from the interleaved stream.
    """
    n = len(make_iterators)
    if n == 1:
        yield from make_iterators[0]()
        return

    if probabilities is None:
        probabilities = [1.0 / n] * n
    p = np.asarray(probabilities, dtype=np.float64)
    assert abs(p.sum() - 1.0) < 1e-6, f"probabilities must sum to 1, got {p.sum()}"

    rng = np.random.default_rng(seed)
    iterators = [iter(f()) for f in make_iterators]
    exhausted = [False] * n

    while True:
        i = int(rng.choice(n, p=p))
        try:
            yield next(iterators[i])
        except StopIteration:
            exhausted[i] = True
            if stopping_strategy == "first_exhausted" or all(exhausted):
                return
            iterators[i] = iter(make_iterators[i]())  # restart (oversample)
            try:
                yield next(iterators[i])
            except StopIteration:
                return  # empty source
