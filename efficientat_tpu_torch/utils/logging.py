"""Run metrics logging: wandb when available, JSONL + stdout always.

Copy of ``efficientat_tpu/utils/logging.py``, verbatim but for import paths:
the port imports nothing of the JAX package.

The reference logs exclusively to wandb (ex_audioset.py:36-42,207-214);
here wandb is optional (gated import) and every run also writes
``<run_dir>/metrics.jsonl`` so air-gapped runs keep full histories.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, project: str, config: Optional[Dict[str, Any]] = None,
                 run_dir: Optional[str] = None, use_wandb: str = "auto"):
        self.run_dir = run_dir or os.path.join(
            "runs", f"{project}-{time.strftime('%Y%m%d-%H%M%S')}")
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        if config:
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump({k: str(v) for k, v in config.items()}, f, indent=2)
        self._wandb = None
        if use_wandb in ("auto", "yes"):
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=config or {})
            except Exception:
                if use_wandb == "yes":
                    raise
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}
        if step is not None:
            record["_step"] = step
        record["_time"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        pretty = ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in record.items() if not k.startswith("_"))
        print(f"[{step}] {pretty}" if step is not None else pretty, flush=True)

    def close(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
