"""Training logger with running means (reference logger.py:6-46).

Prints every SUM_FREQ steps and appends JSONL (instead of TensorBoard —
no external deps); the metrics set matches the reference (rot/trans error,
bad-rot/bad-tr rates, residual, flow EPE, 1px accuracy).
"""
import json
import os

SUM_FREQ = 100


class Logger:
    def __init__(self, name, log_dir="runs", sum_freq=SUM_FREQ):
        self.name = name
        self.total_steps = 0
        self.running = {}
        self.sum_freq = sum_freq
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        os.makedirs(log_dir, exist_ok=True)

    def _flush(self, lr=None):
        means = {k: v / self.sum_freq for k, v in self.running.items()}
        header = f"[{self.total_steps + 1:6d}" + (f", {lr:10.7f}] " if lr is not None else "] ")
        print(header + ", ".join(f"{k}={v:10.4f}" for k, v in means.items()))
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": self.total_steps, **means}) + "\n")
        self.running = {}

    def push(self, metrics, lr=None):
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.sum_freq == self.sum_freq - 1:
            self._flush(lr)
        self.total_steps += 1

    def write_dict(self, results):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": self.total_steps, **results}) + "\n")
