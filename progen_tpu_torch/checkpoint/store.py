"""Checkpoint store of the port (the semantics of
progen_tpu/checkpoint/store.py, written with ``torch.save`` and JSON).

Layout: one directory per TRAINING STEP under the store's path, holding

* ``params.pt``: the parameters by ``state_dict`` name, CPU tensors;
* ``opt_state.pt``: the optimizer state (``OptState.state_dict()``: Adam's
  count, the micro-step, both moments and the accumulator), CPU tensors;
* ``meta.json``: ``next_seq_index`` (the data stream's resume cursor),
  ``model_config``, ``run_id`` (the tracker's) and ``train_step``
  (micro-steps).

The params are stored apart from the optimizer state, so inference
restores them without reading the moments (:meth:`restore_params` never
opens ``opt_state.pt``).  Files are loaded with
``torch.load(weights_only=True)``: tensors, numbers and containers only.

A step is written into a temporary directory, each file flushed to disk,
and renamed into place; a failed attempt leaves no step behind.  Every
storage operation is retried through ``RetryPolicy.from_env
("PROGEN_CKPT_RETRY")`` with the fault points ``ckpt.steps``, ``ckpt.save``
and ``ckpt.restore``; a save that outlasts its retries raises
:class:`~progen_tpu_torch.resilience.retry.RetryError`.

Local paths only: ``gs://`` raises (the port has no GCS client).  One
process writes; :meth:`reached_preemption` is always False (the trainer's
SIGTERM flag does that job without a coordination service).
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any

import torch

from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryPolicy, retry_call
from progen_tpu_torch.train.optimizer import copy_into
from progen_tpu_torch.train.step import TrainState

PARAMS_FILE = "params.pt"
OPT_STATE_FILE = "opt_state.pt"
META_FILE = "meta.json"


def to_cpu(tree: Any) -> Any:
    """``tree`` (nested dicts of tensors, numbers and None) with every
    tensor detached on the CPU; CPU tensors are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree


def _save_file(obj: Any, path: Path) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointStore:
    def __init__(self, path: str, keep_last_n: int | None = 500,
                 retry_policy: RetryPolicy | None = None):
        if str(path).startswith("gs://"):
            raise ValueError(f"{path}: gs:// paths are not ported (the port has "
                             "no GCS client); use a local checkpoint path")
        self._path = Path(path)
        self._keep_last_n = keep_last_n
        self._retry = retry_policy or RetryPolicy.from_env("PROGEN_CKPT_RETRY")

    @property
    def path(self) -> Path:
        return self._path

    def step_dir(self, step: int) -> Path:
        return self._path / str(int(step))

    def reset(self) -> None:
        """Delete every checkpoint (the y/n confirm lives in the CLI)."""
        if self._path.exists():
            shutil.rmtree(self._path)

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first (a step is committed once its
        directory, with ``meta.json`` in it, is renamed into place)."""
        if not self._path.is_dir():
            return []
        return sorted(int(p.name) for p in self._path.iterdir()
                      if p.name.isdigit() and (p / META_FILE).is_file())

    def latest_step(self) -> int | None:
        def _steps():
            faults.inject("ckpt.steps")
            steps = self.all_steps()
            return steps[-1] if steps else None

        return retry_call(_steps, policy=self._retry, label="ckpt.steps")

    def reached_preemption(self, step: int) -> bool:
        """Always False: one process has no coordination service to agree
        on a preemption notice; the trainer's SIGTERM flag is the signal."""
        return False

    def save(
        self,
        step: int,
        state: Any,
        *,
        next_seq_index: int,
        model_config: dict,
        run_id: str | None = None,
        overwrite: bool = False,
    ) -> bool:
        """Write ``state`` (a ``TrainState``: ``params`` by name and an
        ``OptState``) as step ``step``; returns True when written.

        A step that is already in the store is left as it is and False
        returned (the trainer's exit or preemption save can land on the step
        of a periodic one), unless ``overwrite=True`` replaces it.  The
        write has finished and is durable when this returns.  Tensors on a
        device are copied to the host here; the trainer's background save
        hands in host copies it made itself."""
        meta = {
            "next_seq_index": int(next_seq_index),
            "model_config": model_config,
            "run_id": run_id,
            "train_step": int(state.step),
        }
        params = to_cpu(dict(state.params))
        opt_state = to_cpu(state.opt_state.state_dict())

        # one retried unit: a failed attempt removes its temporary
        # directory, so the membership check reruns against unchanged truth
        def _issue() -> bool:
            faults.inject("ckpt.save")
            final = self.step_dir(step)
            if step in self.all_steps() and not overwrite:
                return False
            self._path.mkdir(parents=True, exist_ok=True)
            tmp = self._path / f".tmp-{int(step)}-{uuid.uuid4().hex[:8]}"
            tmp.mkdir()
            try:
                _save_file(params, tmp / PARAMS_FILE)
                _save_file(opt_state, tmp / OPT_STATE_FILE)
                with open(tmp / META_FILE, "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(tmp)
                if final.exists():
                    old = self._path / f".old-{int(step)}-{uuid.uuid4().hex[:8]}"
                    final.rename(old)
                    tmp.rename(final)
                    shutil.rmtree(old)
                else:
                    tmp.rename(final)
                _fsync_dir(self._path)
            finally:
                if tmp.exists():
                    shutil.rmtree(tmp)
            return True

        saved = retry_call(_issue, policy=self._retry, label=f"ckpt.save[{step}]")
        if saved and self._keep_last_n:
            for old_step in self.all_steps()[:-self._keep_last_n]:
                shutil.rmtree(self.step_dir(old_step), ignore_errors=True)
        return saved

    def wait_until_finished(self) -> None:
        """Nothing to wait for: :meth:`save` returns once its write is
        committed (the trainer runs background saves on its own thread and
        joins it)."""

    def _restore(self, step: int | None, label: str, load):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None

        def _load():
            faults.inject("ckpt.restore")
            return load(self.step_dir(step))

        return retry_call(_load, policy=self._retry, label=f"{label}[{step}]")

    def restore_meta(self, step: int | None = None) -> dict | None:
        """Metadata only: enough to rebuild the model config before the
        state is restored; None for an empty store."""
        def load(d: Path) -> dict:
            return json.loads((d / META_FILE).read_text())

        return self._restore(step, "ckpt.restore_meta", load)

    def restore_params(self, step: int | None = None,
                       map_location: torch.device | str = "cpu") -> dict | None:
        """The parameters by ``state_dict`` name, on ``map_location``; None
        for an empty store.  The optimizer's file is not opened."""
        def load(d: Path) -> dict:
            return torch.load(d / PARAMS_FILE, map_location=map_location,
                              weights_only=True)

        return self._restore(step, "ckpt.restore_params", load)

    def restore_state(self, state: Any, step: int | None = None, pieces=None):
        """The full train state, copied IN PLACE into ``state``'s tensors (a
        ``TrainState`` whose params are the live model's), on their device;
        returns the restored ``TrainState`` at the stored step, or None for
        an empty store.  ``pieces(name)``: the packed pieces of a parameter
        sharded over a tensor axis (``parallel/sharding.py``)."""
        device = next(iter(state.params.values())).device

        def load(d: Path):
            params = torch.load(d / PARAMS_FILE, map_location=device, weights_only=True)
            opt_state = torch.load(d / OPT_STATE_FILE, map_location=device,
                                   weights_only=True)
            meta = json.loads((d / META_FILE).read_text())
            return params, opt_state, meta

        out = self._restore(step, "ckpt.restore_state", load)
        if out is None:
            return None
        params, opt_state, meta = out
        copy_into(state.params, params, "params", pieces)
        return TrainState(step=int(meta["train_step"]), params=state.params,
                          opt_state=state.opt_state.load_state_dict(opt_state, pieces))

    def close(self) -> None:
        """Nothing to release: every write has committed when ``save``
        returns."""
