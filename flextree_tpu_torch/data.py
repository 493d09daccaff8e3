"""Data pipeline: deterministic token batching with background prefetch.

The port's own copy of ``flextree_tpu/data.py`` (pure NumPy, so the two
give the same batches bitwise): a sliding-window language-modeling
dataset over a flat token array (memory-mappable), deterministic
per-epoch shuffling (seeded, resumable from any step), and a
background-thread prefetcher that keeps the next batches in flight so the
host never stalls the device step loop.

Determinism contract: ``batch_at(step)`` is a pure function of
``(tokens, batch, seq_len, seed, step)`` — resuming a run at step k
produces exactly the batches a straight-through run would see, which is
what makes checkpoint/resume training bitwise-reproducible end to end
(pinned with the trainer tests).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["LMDataset", "synthetic_tokens", "prefetch"]


def synthetic_tokens(n: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """A deterministic pseudo-corpus with local structure (not iid noise):
    a random walk over the vocabulary, so a model can actually learn."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, size=n)
    walk = np.cumsum(steps) + vocab_size // 2
    return np.mod(walk, vocab_size).astype(np.int32)


class LMDataset:
    """Sliding-window next-token-prediction batches over a token array.

    Windows of length ``seq_len + 1`` start every ``seq_len`` tokens
    (non-overlapping targets); each epoch visits every window once in a
    seeded shuffled order.  ``batch_at(step)`` indexes the infinite
    epoch-concatenated stream, so any step is addressable directly.
    """

    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 seed: int = 0):
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D, got {tokens.shape}")
        self.tokens = tokens
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.num_windows = (tokens.size - 1) // seq_len
        if self.num_windows < batch:
            raise ValueError(
                f"{tokens.size} tokens give {self.num_windows} windows of "
                f"seq_len={seq_len}; need at least batch={batch}"
            )
        self.batches_per_epoch = self.num_windows // batch
        self._order_cache: tuple[int, np.ndarray] | None = None

    def _epoch_order(self, epoch: int) -> np.ndarray:
        # memoized: the permutation is O(num_windows) to build and batch_at
        # is called once per training step within the same epoch
        if self._order_cache is None or self._order_cache[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._order_cache = (epoch, rng.permutation(self.num_windows))
        return self._order_cache[1]

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, targets), each (batch, seq_len) int32, for ``step``."""
        epoch, within = divmod(step, self.batches_per_epoch)
        order = self._epoch_order(epoch)
        idx = order[within * self.batch : (within + 1) * self.batch]
        starts = idx * self.seq_len
        windows = np.stack(
            [self.tokens[s : s + self.seq_len + 1] for s in starts]
        ).astype(np.int32)
        return windows[:, :-1], windows[:, 1:]

    def iter_from(self, step: int = 0):
        """Infinite iterator of batches starting at ``step``."""
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(iterator, size: int = 2):
    """Pull ``size`` items ahead on a daemon thread.

    The consumer's next item is already materialized while the current
    step runs.  Exceptions from the source re-raise at the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        """Blocking put that aborts when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            put((_END, e))
            return
        put((_END, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        # consumer abandoned us (break / close / error): release the worker
        stop.set()
