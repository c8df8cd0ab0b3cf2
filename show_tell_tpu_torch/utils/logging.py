"""Structured metrics logging (counterpart of show_tell_tpu/utils/logging.py):
an append-only JSONL channel beside the reference's stdout prints."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics log: one record per event."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def log(self, event: str, step: Optional[int] = None, **fields: Any) -> None:
        record: Dict[str, Any] = {"ts": time.time(), "event": event}
        if step is not None:
            record["step"] = step
        record.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
