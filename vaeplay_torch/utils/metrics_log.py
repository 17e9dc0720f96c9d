"""Structured metric logging -- the port's copy of
vaeplay_tpu/utils/metrics_log.py: an append-only JSONL stream per run dir
beside the console prints (the reference prints running averages only,
train_BE.py:66-76)."""

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)

    def log(self, step: int, metrics: Dict[str, float], epoch: Optional[int] = None,
            **extra) -> None:
        rec = {"ts": time.time(), "step": int(step),
               **{k: float(v) for k, v in metrics.items()}, **extra}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
