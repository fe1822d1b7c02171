"""Persistent training metrics: one JSONL line per epoch.

Counterpart of autolabel_tpu/train/metrics.py, with the same file and
keys, so either package's plotting reads the other's runs: an
append-only <workspace>/metrics.jsonl. The trainer logs once per epoch,
at its boundary, so the inner loop never waits for the card here.
"""
import json
import os
import time


class MetricsLogger:

    def __init__(self, workspace, filename='metrics.jsonl'):
        os.makedirs(workspace, exist_ok=True)
        self.path = os.path.join(workspace, filename)
        self._start = time.time()

    def log(self, epoch, step, losses, lr=None):
        """losses: dict of 0-dim tensors or floats (read here)."""
        record = {
            'epoch': int(epoch),
            'step': int(step),
            'wall_s': round(time.time() - self._start, 2),
        }
        if lr is not None:
            record['lr'] = float(lr)
        for key, value in losses.items():
            record[key] = float(value)
        with open(self.path, 'a') as f:
            f.write(json.dumps(record) + '\n')
        return record


def read_metrics(workspace, filename='metrics.jsonl'):
    """Parse a metrics file back into a list of dicts."""
    path = os.path.join(workspace, filename)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
