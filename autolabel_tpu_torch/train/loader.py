"""Host-side prefetching: batch assembly and the host-to-card copy overlap
the training step.

Counterpart of autolabel_tpu/train/loader.py, kept as the port's own copy:
a background thread runs the numpy sampler and applies `transform` (the
trainer's _device_batch, which copies the batch to the card) while the
card computes, keeping `depth` batches ready.
"""
import queue
import threading


class PrefetchIterator:
    """Wrap an iterable; a worker thread applies `transform` and keeps
    `depth` ready batches queued. An exception in the worker is raised on
    the consumer's side."""

    def __init__(self, iterable, transform=None, depth=3):
        self.iterable = iterable
        self.transform = transform or (lambda x: x)
        self.depth = depth

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error = []

        def worker():
            try:
                for item in self.iterable:
                    q.put(self.transform(item))
            except BaseException as e:  # surfaced on the consumer side
                error.append(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
