"""``.h5`` path-list dataset management — the reference's dataset index
format.

The legacy training stack never stores patch tensors in one archive; it
stores a flat HDF5 file with a single variable-length-string dataset
``"data_path"`` listing the ``.mat`` patch files, plus ``.npy`` split
arrays (DenoisingGCN/datautils.py:93-138 ``saveH5``/``preDataPath``;
PatchGeneration/Modules/Network/DataUtils.py:145-307 ``DatasetManager``;
DenoisingGCN/train.py:32-61 ``splitData``/``reSplitData``). The shipped
fixture ``DenoisingGCN/testsamples/TestDataPath.h5`` is this format.

Two split conventions exist upstream; both are supported:

* ``DatasetManager`` format — one int array whose first element is the
  dataset size and whose tail is the validation indices
  (DataUtils.py:248,264-283);
* ``val_index.npy`` format — just the validation indices, dataset size
  implied (train.py:46-61).

``h5py`` is optional at import time: everything else in ngpd_tpu works
without it, and these functions raise a clear error when it is absent.

The port's own copy of ``ngpd_tpu/io/h5paths.py``, so that the port imports
nothing of the JAX package; ``tests/test_torch_train_data.py`` holds the two
equal. ``h5py`` is imported only inside the functions that need it: nothing
on the card's path imports it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "h5py is required for .h5 path-list IO (pip install h5py)"
        ) from e
    return h5py


def save_path_list(
    target: PathLike, paths: Sequence[str], overwrite: bool = False
) -> None:
    """Write a ``data_path`` vlen-string dataset (saveH5,
    datautils.py:111-121; DatasetManager.saveDataset,
    DataUtils.py:196-217 including its no-overwrite guard)."""
    h5py = _h5py()
    target = Path(target)
    if target.suffix != ".h5":
        raise ValueError(f"path list target must end with .h5: {target}")
    if target.exists() and not overwrite:
        raise FileExistsError(f"refusing to overwrite {target}")
    target.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(list(paths), dtype=object)
    with h5py.File(str(target), "w") as f:
        ds = f.create_dataset(
            "data_path", arr.shape, dtype=h5py.special_dtype(vlen=str)
        )
        ds[:] = arr


def load_path_list(source: PathLike) -> np.ndarray:
    """Read a path-list ``.h5`` -> 1-D array of ``str`` (loadDataset,
    DataUtils.py:219-229)."""
    h5py = _h5py()
    with h5py.File(str(source), "r") as f:
        raw = np.asarray(f["data_path"])
    return np.array(
        [p.decode() if isinstance(p, bytes) else str(p) for p in raw.ravel()]
    )


def scan_mat_folders(
    folders: Sequence[PathLike],
    max_files_per_folder: int = -1,
    skip_prefixes: Sequence[str] = (),
    seed: int = 0,
) -> np.ndarray:
    """Collect ``.mat`` patch paths from per-model folders.

    Mirrors ``preDataPath`` (datautils.py:93-107 — its ``'9'`` filename
    prefix skip is the upstream held-out-model convention, exposed here
    as ``skip_prefixes``) and ``generateDatasetFromFolders``
    (DataUtils.py:182-194 with ``maxFilesPerFolder`` subsampling).
    """
    rng = np.random.default_rng(seed)
    out: list[str] = []
    for folder in folders:
        folder = Path(folder)
        if not folder.is_dir():
            raise ValueError(f"not a dataset folder: {folder}")
        names = sorted(
            n
            for n in os.listdir(folder)
            if n.endswith(".mat")
            and not any(n.startswith(p) for p in skip_prefixes)
        )
        if not names:
            raise ValueError(f"no .mat files under {folder}")
        if 0 <= max_files_per_folder < len(names):
            keep = rng.choice(
                len(names), size=max_files_per_folder, replace=False
            )
            names = [names[i] for i in sorted(keep)]
        out.extend(str(folder / n) for n in names)
    return np.array(out)


def make_split(
    num_data: int,
    val_fraction: float,
    batch_size: int = 256,
    seed: int = 0,
) -> np.ndarray:
    """DatasetManager-format split array: ``[num_data, val_indices...]``
    with the validation count rounded to whole batches
    (DataUtils.py:231-249)."""
    if not 0 < val_fraction < 1:
        raise ValueError(f"val_fraction must be in (0, 1): {val_fraction}")
    num_batches = num_data // batch_size
    num_val = int(num_batches * val_fraction) * batch_size
    if num_val == 0 or num_val >= num_data:
        raise ValueError(
            f"bad split: {num_data} samples, batch {batch_size}, "
            f"fraction {val_fraction} -> {num_val} validation samples"
        )
    rng = np.random.default_rng(seed)
    val = rng.choice(num_data, size=num_val, replace=False)
    return np.insert(np.asarray(val, np.int64), 0, num_data)


def save_split(target: PathLike, split: np.ndarray) -> None:
    target = Path(target)
    if target.suffix != ".npy":
        raise ValueError(f"split target must end with .npy: {target}")
    target.parent.mkdir(parents=True, exist_ok=True)
    np.save(str(target), np.asarray(split, np.int64))


def load_split(source: PathLike, num_data: int) -> np.ndarray:
    """Load + validate a DatasetManager split (the structural checks of
    DataUtils.py:264-283: 1-D ints, header == dataset size == max)."""
    split = np.load(str(source))
    if split.ndim != 1 or not np.issubdtype(split.dtype, np.integer):
        raise ValueError("split must be a 1-D integer array")
    if split[0] != num_data:
        raise ValueError(
            f"split is for a dataset of size {split[0]}, have {num_data}"
        )
    if split[0] != split.max():
        raise ValueError("split header must be the largest element")
    return split


def split_paths(
    paths: np.ndarray, split: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_paths, val_paths) from a DatasetManager split array
    (DataUtils.py:285-307)."""
    val_idx = np.asarray(split[1:], np.int64)
    train_idx = np.setdiff1d(np.arange(len(paths)), val_idx)
    return paths[train_idx], paths[val_idx]


def split_paths_by_val_index(
    paths: np.ndarray, val_index: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The train.py ``val_index.npy`` convention (train.py:52-61)."""
    val_idx = np.asarray(val_index, np.int64)
    train_idx = np.setdiff1d(np.arange(len(paths)), val_idx)
    return paths[train_idx], paths[val_idx]


def load_patch_batch(paths: Sequence[str], num_nodes: int = 64) -> dict:
    """Stack ``.mat`` patches from a path list into network-ready arrays
    — the MatrixDataset collation (datautils.py:16-91): ``x``
    (B, 20, num_nodes) float32 plus ``gt_norm``/``center_norm`` (B, 3)
    where present in every file."""
    from .matpatch import load_mat_patch

    patches = [load_mat_patch(p, num_nodes) for p in paths]
    out = {"x": np.stack([p["x"] for p in patches])}
    for key in ("gt_norm", "center_norm"):
        if all(key in p for p in patches):
            out[key] = np.stack([p[key] for p in patches])
    return out
