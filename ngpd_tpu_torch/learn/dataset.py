"""Patch dataset generation and loading (torch), as ``ngpd_tpu/learn/dataset.py``.

For every raw object x noise level (Gaussian and impulsive,
``TrainConfig``'s levels) ``generate_dataset`` loads or samples the cloud,
estimates and orients its normals (the ground truth), corrupts it,
re-estimates normals on the noisy cloud and extracts one MD patch per
point, then keeps every patch whose centre is an MD feature point
(``md_features != 1``) and ``balance_ratio`` times as many of the others,
chosen by ``numpy.random.default_rng(seed)``. Shards are ``.npz`` files
with the reference's keys and dtypes (``x``, ``nbr_idx`` int32,
``nbr_mask``, ``node_mask``, ``y``, ``r_inv``) and ``manifest.json`` splits
them by a persisted permutation, so each package reads the other's shards.

The noise is drawn from a ``torch.Generator`` seeded with
``TrainConfig.seed`` (``core/noise.py::draw_noise``, other numbers than
the reference's ``jax.random``); ``process_cloud`` takes the draws, so the
tests feed it the reference's own. ``PatchDataset`` yields batches in the
reference's order for the same seed (a numpy permutation), gathered on the
device from the split staged there once when it fits ``NGPD_STAGE_BYTES``
(each gather the span ``ngpd.train.batch``); it reads a split's shards, or
takes their arrays in memory (``from_arrays``).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import PatchConfig, TrainConfig
from ..core import noise as noise_mod
from ..core import voting
from ..core.normals import orient_normals, pvt_normals
from ..core.patches import extract_patches, md_selection
from ..device import exact_float32, resolve_device
from ..io.obj import load_obj, read_obj
from ..io.sampling import sample_mesh
from ..ops import metrics
from ..ops.knn import knn
from ..utils import prof

KEYS = ("x", "nbr_idx", "nbr_mask", "node_mask", "y", "r_inv")


class _Stages:
    """Seconds per stage, each synchronized, when ``times`` is a dict."""

    def __init__(self, times: Optional[dict], device: torch.device):
        self.times, self.device, self.t = times, device, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.times is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        self.t = now


def process_cloud(
    points: torch.Tensor,
    draws,
    noise_level: float,
    noise_type: int,
    patch_cfg: PatchConfig = PatchConfig(),
    balance_ratio: Optional[float] = None,
    balance_seed: int = 0,
    device=None,
    times: Optional[dict] = None,
) -> dict:
    """Cloud -> dict of numpy patch arrays (one patch per kept point).
    ``draws``: ``draw_noise(len(points), generator)``, the Gaussian draws
    and the permutation. With ``times`` (a dict), the seconds of the kNN
    searches (``knn``) and of the rest (``rest``) are added to it."""
    dev = resolve_device(device)
    exact_float32()
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    clock = _Stages(times, dev)
    nbh, _ = knn(points, 12, exclude_self=True)
    nbh6, _ = knn(points, 6)
    clock.mark("knn")
    gt_n = orient_normals(points, pvt_normals(points, nbh), nbh)
    mel = metrics.average_edge_length(points, nbh6)
    gauss, perm = draws
    noisy = noise_mod.apply_noise(points, gt_n, gauss, perm, noise_level, mel,
                                  noise_type=noise_type)
    clock.mark("rest")
    nbh_noisy, _ = knn(noisy, 12, exclude_self=True)
    clock.mark("knn")
    noisy_n = orient_normals(noisy, pvt_normals(noisy, nbh_noisy), nbh_noisy)
    clock.mark("rest")
    selection = md_selection(noisy, patch_cfg)
    clock.mark("knn")
    batch = extract_patches(noisy, noisy_n, gt_normals=gt_n, cfg=patch_cfg, device=dev,
                            selection=selection)

    keep = np.arange(points.shape[0])
    if balance_ratio is not None:
        # MD classes of the noisy cloud.
        nbh_p, mass, _ = selection
        dec, _ = voting.md_transformation(noisy, nbh_p, noisy_n, mass)
        md = voting.md_features(dec).cpu().numpy()
        feature_idx = np.where(md != 1)[0]
        flat_idx = np.where(md == 1)[0]
        rng = np.random.default_rng(balance_seed)
        n_keep = min(len(flat_idx), int(balance_ratio * max(len(feature_idx), 1)))
        kept_flat = rng.permutation(flat_idx)[:n_keep]
        keep = np.concatenate([feature_idx, kept_flat])
        keep.sort()

    sel = torch.as_tensor(keep, device=dev)
    out = {k: getattr(batch, k)[sel].cpu().numpy() for k in KEYS}
    out["nbr_idx"] = out["nbr_idx"].astype(np.int32)
    clock.mark("rest")
    return out


def load_raw(path: str | Path, sample_points: Optional[int] = None) -> torch.Tensor:
    """A raw .obj as points (CPU); surface-sampled when ``sample_points``
    is given and the file has faces."""
    path = Path(path)
    if sample_points is not None:
        data = read_obj(path)
        if data.fv.shape[0] > 0:
            return sample_mesh(data.v, data.fv, sample_points).points
    return load_obj(path).points


def generate_dataset(
    raw_paths: Sequence[str | Path],
    out_dir: str | Path,
    train_cfg: TrainConfig = TrainConfig(),
    patch_cfg: PatchConfig = PatchConfig(),
    sample_points: Optional[int] = None,
    balance: bool = True,
    device=None,
    times: Optional[dict] = None,
) -> dict:
    """All objects x all noise levels -> .npz shards + split manifest, on
    ``device``. ``times``: see ``process_cloud``."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(dev).manual_seed(train_cfg.seed)
    shards = []
    levels = [(lv, noise_mod.GAUSSIAN) for lv in train_cfg.gaussian_noise_levels]
    levels += [(lv, noise_mod.IMPULSIVE) for lv in train_cfg.impulsive_noise_levels]
    for path in raw_paths:
        pts = load_raw(path, sample_points).to(dev)
        for level, ntype in levels:
            data = process_cloud(
                pts, noise_mod.draw_noise(pts.shape[0], gen), level, ntype, patch_cfg,
                balance_ratio=train_cfg.balance_ratio if balance else None,
                balance_seed=train_cfg.seed, device=dev, times=times,
            )
            name = f"{Path(path).stem}_t{ntype}_l{level}.npz"
            np.savez_compressed(out / name, **data)
            shards.append({"file": name, "count": int(len(data["y"]))})

    # Persisted split over shards.
    rng = np.random.default_rng(train_cfg.seed)
    perm = rng.permutation(len(shards)).tolist()
    n = len(shards)
    n_train = int(train_cfg.split[0] * n)
    n_val = int(train_cfg.split[1] * n)
    manifest = {
        "shards": shards,
        "perm": perm,
        "train": perm[:n_train],
        "val": perm[n_train : n_train + n_val],
        "test": perm[n_train + n_val :],
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


class PatchDataset:
    """Batch iterator over generated shards: dense batches on ``device``,
    no worker processes."""

    # Below this size the whole split is staged on the device once and a
    # batch is one gather there.
    DEVICE_STAGE_BYTES = int(os.environ.get("NGPD_STAGE_BYTES", 2 << 30))

    def __init__(self, root: str | Path, split: str = "train", device=None):
        self.root = Path(root)
        manifest = json.loads((self.root / "manifest.json").read_text())
        self.files = [self.root / manifest["shards"][i]["file"] for i in manifest[split]]
        arrays = []
        for f in self.files:
            with np.load(f) as a:
                arrays.append({k: a[k] for k in KEYS})
        self._hold(arrays, device)

    @classmethod
    def from_arrays(cls, arrays: Sequence[dict], device=None) -> "PatchDataset":
        """The data set of patches in memory, each of ``arrays`` one shard's
        arrays as ``process_cloud`` returns them, in the split's order: the
        batches and the staging of the same arrays saved as the split's
        shards."""
        ds = cls.__new__(cls)
        ds.root, ds.files = None, []
        ds._hold([{k: a[k] for k in KEYS} for a in arrays], device)
        return ds

    def _hold(self, arrays: list, device) -> None:
        self.device = resolve_device(device)
        if arrays:
            self.data = {k: np.concatenate([a[k] for a in arrays]) for k in KEYS}
        else:
            self.data = {k: np.zeros((0,)) for k in KEYS}
        self._dev = None

    def __len__(self):
        return len(self.data["y"])

    def _to_device(self, v: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(v)
        return (t.to(torch.int64) if t.dtype == torch.int32 else t).to(self.device)

    def _staged(self):
        if self._dev is None:
            total = sum(v.nbytes for k, v in self.data.items() if k != "r_inv")
            self._dev = ({k: self._to_device(v) for k, v in self.data.items() if k != "r_inv"}
                         if total <= self.DEVICE_STAGE_BYTES else False)
        return self._dev

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[dict]:
        n = len(self)
        order = np.random.default_rng(seed).permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        dev = self._staged()
        for s in range(0, stop, batch_size):
            sel = order[s : s + batch_size]
            with prof.span("ngpd.train.batch", self.device):
                if dev:
                    idx = torch.as_tensor(sel, device=self.device)
                    batch = {k: v[idx] for k, v in dev.items()}
                else:
                    batch = {k: self._to_device(v[sel]) for k, v in self.data.items()
                             if k != "r_inv"}
            yield batch
