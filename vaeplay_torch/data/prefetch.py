"""Host input pipeline: batch prefetching and parallel sample loading -- the
port's own copy of vaeplay_tpu/data/prefetch.py (pure Python).

The reference feeds every trainer through `torch.utils.data.DataLoader(...,
num_workers=args.workers)` (e.g. train_BE.py:115-121). Here, as in the JAX
package, two levers do that work:

  * `prefetch(iterable)`: a producer thread drains a batch iterator into a
    queue of PREFETCH_DEPTH batches, so that the host prepares batch i+1
    while the device runs batch i (CUDA launches return before the device
    finishes).
  * `pooled_items(load_fn, indices, workers)`: an ordered thread-pool map
    for the file-backed datasets' `epoch_batches(workers=N)`. PIL decode and
    resize release the interpreter lock, so they run on `workers` threads;
    at most `workers * INFLIGHT_PER_WORKER` loads are in flight, and results
    come back in index order whatever the threads' timing.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T")

_SENTINEL = object()
PREFETCH_DEPTH = 2  # batches the producer thread keeps ready
INFLIGHT_PER_WORKER = 4  # loads queued on the pool per worker thread


class _PrefetchIterator:
    """Iterator over `src` driven by a background producer thread.

    Exceptions raised by the source iterator are re-raised in the consumer.
    Abandoning the iterator (GC / `close()`) unblocks and stops the producer.
    """

    def __init__(self, src: Iterable):
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(iter(src),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._put_forever(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which raises it
            self._put_forever(e)

    def _put_forever(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()

    def __del__(self):  # pragma: no cover - GC timing
        self._stop.set()


def prefetch(src: Iterable) -> _PrefetchIterator:
    """Wrap a batch iterator so the host prepares up to PREFETCH_DEPTH batches
    ahead on a background thread."""
    return _PrefetchIterator(src)


def batched_loads(load_fn: Callable[[int], T], order: Sequence[int], batch_size: int,
                  workers: int = 0) -> Iterator[list]:
    """Yield lists of `load_fn(i)` results grouped into full batches (a last
    partial batch is dropped). With workers > 0 the loads are pooled across
    batch boundaries, in index order."""
    stop = (len(order) // batch_size) * batch_size
    it = pooled_items(load_fn, [int(i) for i in order[:stop]], workers)
    for _ in range(0, stop, batch_size):
        yield [next(it) for _ in range(batch_size)]


def epoch_iterator(dset, batch_size: int, seed: int = 0, workers: int = 0):
    """The trainers' input pipeline: `dset.epoch_batches(batch_size, seed,
    workers)` in a `prefetch` thread."""
    return prefetch(dset.epoch_batches(batch_size, seed, workers))


def pooled_items(load_fn: Callable[[int], T], indices: Sequence[int],
                 workers: int) -> Iterator[T]:
    """Yield `load_fn(i)` for each index, in order. workers <= 0 is a plain
    sequential map; otherwise up to `workers * INFLIGHT_PER_WORKER` loads run
    at once on a thread pool. `load_fn` must be thread-safe."""
    if workers <= 0:
        for i in indices:
            yield load_fn(i)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        indices = list(indices)
        window = workers * INFLIGHT_PER_WORKER
        futures = [pool.submit(load_fn, i) for i in indices[:window]]
        next_submit = window
        for k in range(len(indices)):
            yield futures[k].result()
            futures[k] = None  # release the loaded item
            if next_submit < len(indices):
                futures.append(pool.submit(load_fn, indices[next_submit]))
                next_submit += 1
