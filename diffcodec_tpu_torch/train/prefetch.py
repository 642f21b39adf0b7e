"""Threaded host-side input pipeline: parallel batch build + prefetch.

Copied from `diffcodec_tpu/train/prefetch.py` (no JAX): the same batches in
the same order, and the same `text_encoder` callback.

The reference overlaps data loading with GPU steps via
`DataLoader(num_workers=...)` worker processes (`train_controlnet.py:942-948`,
SURVEY.md 3.1's worker-process boundary).  The port's equivalent, as the
JAX package's, is a thread pool (the per-sample work, PIL decodes, .flo
reads and numpy jitter, releases the GIL for much of its time) producing
batches ahead of the consumer, so the card waits on the host less.

Batches are delivered in deterministic order (same sequence as the
synchronous iterator) regardless of worker completion order.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


class PrefetchLoader:
    """Order-preserving parallel batch loader over an indexable dataset.

    dataset: supports len() and __getitem__ -> {key: np.ndarray, 'text': str}
    collate: optional fn(list_of_samples) -> batch dict; the default stacks
    array keys and gathers 'text' into a list (UniDataset.iter_batches
    semantics).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, shuffle: bool = True,
                 seed: int = 0,
                 collate: Optional[Callable] = None,
                 text_encoder: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shuffle = shuffle
        self.collate = collate or self._default_collate
        self.text_encoder = text_encoder
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _default_collate(samples: Sequence[Dict]) -> Dict:
        batch = {k: np.stack([s[k] for s in samples])
                 for k in samples[0] if k != "text"}
        if "text" in samples[0]:
            batch["text"] = [s["text"] for s in samples]
        return batch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def epoch(self) -> Iterator[Dict]:
        """One epoch of batches, prefetched by the worker pool but yielded
        in the deterministic epoch order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n_batches = len(self)
        batch_indices = [order[i * self.batch_size:(i + 1) * self.batch_size]
                         for i in range(n_batches)]

        done: Dict[int, Dict] = {}
        done_lock = threading.Lock()
        done_cv = threading.Condition(done_lock)
        next_job = [0]
        job_lock = threading.Lock()
        errors: list = []
        # bound how far ahead workers may run past the consumer
        consumed = [0]

        def worker():
            while True:
                with job_lock:
                    j = next_job[0]
                    if j >= n_batches or errors:
                        return
                    next_job[0] = j + 1
                # backpressure: stay within `prefetch` of the consumer
                with done_cv:
                    while (j - consumed[0] > self.prefetch and
                           not errors):
                        done_cv.wait(timeout=0.1)
                    if errors:
                        return
                try:
                    samples = [self.dataset[int(i)] for i in
                               batch_indices[j]]
                    batch = self.collate(samples)
                except Exception as e:  # surface in the consumer thread
                    with done_cv:
                        errors.append(e)
                        done_cv.notify_all()
                    return
                with done_cv:
                    done[j] = batch
                    done_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for j in range(n_batches):
                with done_cv:
                    while j not in done and not errors:
                        done_cv.wait(timeout=0.5)
                    if errors:
                        raise errors[0]
                    batch = done.pop(j)
                    consumed[0] = j + 1
                    done_cv.notify_all()
                if self.text_encoder is not None and "text" in batch:
                    batch["text_embeds"] = self.text_encoder(batch["text"])
                yield batch
        finally:
            with done_cv:
                if not errors:
                    errors.append(StopIteration())
                done_cv.notify_all()
            for t in threads:
                t.join(timeout=2.0)
