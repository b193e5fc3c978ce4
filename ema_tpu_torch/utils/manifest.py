"""Shard-level progress manifests (checkpoint/resume for align runs).

The reference's restartability is shell-granular: any bucket's align job
can be rerun because its inputs are immutable files (SURVEY.md §5.3-5.4).
This module keeps that property and adds bookkeeping: a JSONL manifest
records every completed work unit (bucket file -> SAM shard), so a
restarted multi-bucket run skips finished buckets and a host failure only
costs its in-flight bucket.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Set


class RunManifest:
    def __init__(self, path: str) -> None:
        self.path = path
        self.done: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self.done[rec["input"]] = rec

    def is_done(self, input_path: str) -> bool:
        rec = self.done.get(os.path.abspath(input_path))
        return bool(rec and (not rec.get("output")
                             or os.path.exists(rec["output"])))

    def mark_done(self, input_path: str, output_path: Optional[str],
                  n_records: int, wall_s: float) -> None:
        rec = {
            "input": os.path.abspath(input_path),
            "output": os.path.abspath(output_path) if output_path else None,
            "records": int(n_records),
            "wall_s": round(float(wall_s), 3),
            "ts": time.time(),
        }
        self.done[rec["input"]] = rec
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
