"""Host-side utilities: the port's copy of ``composer_tpu/utils.py``, a parallel
map with progress (parity: composer/utils.py:11-91).

Unlike the original, worker processes start with the ``spawn`` method, not
``fork``: the port's processes hold PyTorch's threads (and, on the card, a
CUDA context), which a forked child must not inherit.

Unlike the reference, ``parallel_map`` honours its worker count everywhere it is
called (the reference's preprocess CLI accepted ``--num-workers`` but silently
ignored it, preprocess.py:174,246-247) and propagates or collects exceptions
explicitly instead of silently storing them in the result list.
"""

from __future__ import annotations

import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed

from tqdm import tqdm


def parallel_map(
    items,
    function,
    num_workers: int = 16,
    use_kwargs: bool = False,
    serial_warmup: int = 3,
    multithread: bool = False,
    show_progress_bar: bool = True,
    return_exceptions: bool = False,
):
    """Applies ``function`` to every element of ``items`` using a worker pool.

    The first ``serial_warmup`` items run serially in the parent process so that
    programming errors surface with a clean traceback before the pool spins up.

    Results are returned in input order. If ``return_exceptions`` is true, a
    failing item's slot holds its exception; otherwise the first failure raises.
    """
    items = list(items)
    call = (lambda a: function(**a)) if use_kwargs else function

    results = [None] * len(items)
    warmup = len(items) if num_workers == 1 else min(serial_warmup, len(items))

    for i in range(warmup):
        try:
            results[i] = call(items[i])
        except Exception as exc:
            if not return_exceptions:
                raise
            results[i] = exc

    if warmup == len(items):
        return results

    if multithread:
        pool = ThreadPoolExecutor(max_workers=num_workers)
    else:
        pool = ProcessPoolExecutor(max_workers=num_workers,
                                   mp_context=multiprocessing.get_context("spawn"))
    with pool:
        future_to_index = {}
        for i in range(warmup, len(items)):
            if use_kwargs:
                future = pool.submit(function, **items[i])
            else:
                future = pool.submit(function, items[i])
            future_to_index[future] = i

        progress = tqdm(
            total=len(future_to_index),
            unit="it",
            unit_scale=True,
            disable=not show_progress_bar,
        )
        for future in as_completed(future_to_index):
            index = future_to_index[future]
            try:
                results[index] = future.result()
            except Exception as exc:
                if not return_exceptions:
                    # Cancel what we can and re-raise with context.
                    for other in future_to_index:
                        other.cancel()
                    progress.close()
                    raise
                logging.debug("parallel_map item %d failed: %s", index, exc)
                results[index] = exc
            progress.update(1)
        progress.close()

    return results
