"""Checkpoints with top-k retention (torch), as ``ngpd_tpu/learn/checkpoints.py``.

The reference writes orbax directories, which need JAX. Here a checkpoint
is a directory ``step_{n}`` holding the model's variables as the repo's
flat ``.npz`` (``variables.npz``, keys ``params/...`` and
``batch_stats/...``: ``predict-normals --ckpt``, ``denoise-mesh --ckpt``
and ``ngpd_tpu/learn/weights.py`` read it as it is) and, beside it,
``train_state.pt``: the step, the optimizer's state and the dropout
generator's state. ``scores.json`` keeps each kept step's score; the
``top_k`` lowest survive, a same-step entry is replaced.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional

import torch

from .weights import load_dgcnn_npz, load_model_variables, model_variables, save_variables_npz

VARIABLES = "variables.npz"
TRAIN_STATE = "train_state.pt"


class CheckpointManager:
    def __init__(self, directory: str | Path, top_k: int = 5):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self._scores_file = self.dir / "scores.json"
        self._scores: dict[str, float] = {}
        if self._scores_file.exists():
            self._scores = json.loads(self._scores_file.read_text())

    def _flush_scores(self):
        self._scores_file.write_text(json.dumps(self._scores, indent=1))

    def save(self, step: int, state: Any, score: float) -> None:
        """Keep the top-k lowest-score checkpoints; a same-step directory
        left from an earlier run is replaced."""
        name = f"step_{step}"
        path = self.dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir()
        save_variables_npz(path / VARIABLES, model_variables(state.model))
        torch.save(state.state_dict(), path / TRAIN_STATE)
        self._scores[name] = float(score)
        self._flush_scores()
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        for victim, _ in ranked[self.top_k:]:
            if (self.dir / victim).exists():
                shutil.rmtree(self.dir / victim)
            self._scores.pop(victim, None)
        self._flush_scores()

    def best_step(self) -> Optional[int]:
        if not self._scores:
            return None
        name = min(self._scores, key=self._scores.get)
        return int(name.split("_")[1])

    def variables_path(self, step: Optional[int] = None) -> Path:
        """The ``.npz`` of a checkpoint (the best by default)."""
        step = self.best_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return self.dir / f"step_{step}" / VARIABLES

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load a checkpoint (the best by default) into ``state``: the
        model's variables, the step, the optimizer's and the generator's
        state. Returns the state."""
        path = self.variables_path(step)
        load_model_variables(state.model, load_dgcnn_npz(path))
        state.load_state_dict(torch.load(path.parent / TRAIN_STATE, map_location="cpu",
                                         weights_only=True))
        return state
