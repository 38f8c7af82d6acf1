"""Experiment tracking: offline-first JSONL with optional wandb mirroring
(copied from progen_tpu/observe/tracker.py without JAX).

The primary sink is a local JSONL stream in ``{out_dir}/{run_id}/`` that
always works; wandb is mirrored to when the package is importable and not
disabled.  The run id round-trips through the checkpoint metadata, so a
resumed run keeps writing to its run directory.  The port runs one
process, which is process 0 and writes.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from pathlib import Path
from typing import Any


def _wandb_or_none():
    try:
        import wandb  # type: ignore

        return wandb
    except Exception:
        return None


def _wandb_init(wandb, kwargs: dict):
    """``wandb.init(**kwargs)`` on a thread of its own; None when it fails.
    A failing init leaves its exception's traceback in wandb's own state,
    and a traceback holds every frame below it: called from the caller's
    thread, that pinned the caller's frames and with them whatever their
    locals held (a whole Trainer on the card, until the process ended).
    The thread's stack ends here."""
    out = [None]

    def run():
        try:
            out[0] = wandb.init(**kwargs)
        except Exception:
            pass

    t = threading.Thread(target=run, name="progen-wandb-init", daemon=True)
    t.start()
    t.join()
    return out[0]


class Tracker:
    def __init__(
        self,
        project: str = "progen-tpu",
        out_dir: str = "./runs",
        run_id: str | None = None,
        disabled: bool = False,
        use_wandb: bool = True,
        config: dict[str, Any] | None = None,
    ):
        self.disabled = disabled
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._wandb_run = None
        self._file = None
        if self.disabled:
            return

        self._dir = Path(out_dir) / self.run_id
        self._dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self._dir / "metrics.jsonl", "a", buffering=1)
        if config:
            (self._dir / "config.json").write_text(json.dumps(config, indent=2))

        wandb = _wandb_or_none() if use_wandb else None
        if wandb is not None:
            kwargs = {"project": project, "config": config or {}}
            if run_id is not None:
                kwargs.update(id=run_id, resume="allow")
            self._wandb_run = _wandb_init(wandb, kwargs)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        if self.disabled:
            return
        row = {"step": int(step), "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(row) + "\n")
        if self._wandb_run is not None:
            self._wandb_run.log(metrics, step=step)

    def log_sample(self, prime: str, sampled: str, step: int) -> None:
        """Generation samples: an HTML fragment file (the reference's Jinja2
        template reduced to an f-string) + wandb.Html."""
        if self.disabled:
            return
        html = (
            f"<i>{prime}</i><br/><br/>"
            f'<div style="overflow-wrap: break-word;">{sampled}</div>'
        )
        with open(self._dir / "samples.html", "a") as f:
            f.write(f"<h4>step {step}</h4>{html}\n")
        if self._wandb_run is not None:
            import wandb  # type: ignore

            self._wandb_run.log({"samples": wandb.Html(html)}, step=step)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb_run is not None:
            self._wandb_run.finish()
            self._wandb_run = None
