"""DGCNN weights for the port: the repo's flat ``.npz`` archives of Flax
variables and the reference's torch checkpoints, as a state dict of
``ngpd_tpu_torch.models.dgcnn.DGCNN``.

``load_dgcnn_npz`` is a copy of ``ngpd_tpu/learn/weights.py``'s (keys
``params/...`` and ``batch_stats/...`` joined by ``/``); ``state_dict_from_variables``
follows ``torch_state_dict_from_variables`` of
``ngpd_tpu/learn/torch_interop.py``:

========================  ===========================================
torch parameter           Flax variable
========================  ===========================================
conv{i}.0.weight          params/conv{i}/Dense_0/kernel   (i = 1..6,
  (C_out, C_in, 1, 1)       transposed from (C_in, C_out))
bn{i}.weight / .bias      params/conv{i}/BatchNorm_0/{scale,bias}
bn{i}.running_mean/var    batch_stats/conv{i}/BatchNorm_0/{mean,var}
conv7.0.weight (E,1024,1) params/conv7/kernel (1024, E)
bn7.*                     params/bn7 + batch_stats/bn7
linear1.weight (512,2E)   params/linear1/kernel (2E, 512)   [no bias]
bn8/9/10.*                params/bn8/9/10 + batch_stats
linear2/3/4.weight+bias   params/linear{2,3,4}/{kernel,bias}
========================  ===========================================

with the ``conv{i}.1`` aliases of the shared BatchNorms and
``num_batches_tracked``, so a strict ``load_state_dict`` takes it.
``load_dgcnn_state_dict`` reads either kind of file; ``variables_from_state_dict``
is the inverse, so a DGCNN trained by the port saves as the same flat
``.npz`` (``dgcnn_variables``).

Patch2Normal (``models/patch2normal.py``) carries the Flax module names, so
its Flax tree maps onto the port's state dict path by path, ``/`` becoming
``.``: ``params/<path>/kernel`` (in, out) is ``<path>.weight`` (out, in),
``params/<path>/bias`` is ``<path>.bias``, a BatchNorm's
``params/<path>/scale`` is ``<path>.weight`` and ``batch_stats/<path>/{mean,var}``
are ``<path>.running_{mean,var}``
(``patch2normal_state_dict_from_variables`` and its inverse
``variables_from_patch2normal_state_dict``). ``BetterDGCNN`` carries the
Flax names too and maps the same way (``better_dgcnn_state_dict_from_variables``,
``variables_from_better_dgcnn_state_dict``). ``model_variables`` and
``load_model_variables`` take any of the three models. ``save_variables_npz``
writes the flat archive that ``ngpd_tpu/learn/weights.py`` reads.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Union

import numpy as np
import torch

_NUM_EDGE_CONVS = 6


def flatten_variables(variables: Mapping) -> dict:
    """Nested variables -> flat {path: array} with '/'-joined keys."""
    flat: dict = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(variables, "")
    return flat


def unflatten_variables(flat: Mapping) -> dict:
    out: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return out


def save_variables_npz(path: Union[str, Path], variables: Mapping) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(str(path), **flatten_variables(variables))


def load_dgcnn_npz(path: Union[str, Path]) -> dict:
    """npz archive -> {"params", "batch_stats"} of numpy arrays."""
    with np.load(str(path)) as data:
        flat = {k: data[k] for k in data.files}
    tree = unflatten_variables(flat)
    if "batch_stats" not in tree:
        tree["batch_stats"] = {}
    return tree


def _bn_out(sd: dict, torch_name: str, bn_p: Mapping, bn_s: Mapping) -> None:
    sd[f"{torch_name}.weight"] = bn_p["scale"]
    sd[f"{torch_name}.bias"] = bn_p["bias"]
    sd[f"{torch_name}.running_mean"] = bn_s["mean"]
    sd[f"{torch_name}.running_var"] = bn_s["var"]
    sd[f"{torch_name}.num_batches_tracked"] = np.asarray(0, np.int64)


def state_dict_from_variables(variables: Mapping) -> dict:
    """Flax DGCNN variables (numpy) -> the port's state dict (tensors)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: dict = {}
    for i in range(1, _NUM_EDGE_CONVS + 1):
        sd[f"conv{i}.0.weight"] = params[f"conv{i}"]["Dense_0"]["kernel"].T[:, :, None, None]
        bn_p = params[f"conv{i}"]["BatchNorm_0"]
        bn_s = stats[f"conv{i}"]["BatchNorm_0"]
        _bn_out(sd, f"bn{i}", bn_p, bn_s)
        _bn_out(sd, f"conv{i}.1", bn_p, bn_s)
    sd["conv7.0.weight"] = params["conv7"]["kernel"].T[:, :, None]
    _bn_out(sd, "bn7", params["bn7"], stats["bn7"])
    _bn_out(sd, "conv7.1", params["bn7"], stats["bn7"])
    sd["linear1.weight"] = params["linear1"]["kernel"].T
    _bn_out(sd, "bn8", params["bn8"], stats["bn8"])
    for li in (2, 3, 4):
        sd[f"linear{li}.weight"] = params[f"linear{li}"]["kernel"].T
        sd[f"linear{li}.bias"] = params[f"linear{li}"]["bias"]
        if li < 4:
            _bn_out(sd, f"bn{li + 7}", params[f"bn{li + 7}"], stats[f"bn{li + 7}"])
    return {k: torch.as_tensor(np.ascontiguousarray(
                v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
            for k, v in sd.items()}


def load_torch_checkpoint(path: Union[str, Path]) -> dict:
    """A reference checkpoint file -> a plain state dict on the CPU: a
    ``.t7`` pickled state dict or a TorchScript ``.pt`` module."""
    path = str(path)
    try:
        # Safe loader first: tensors only, no pickled code execution.
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        try:
            # TorchScript archives are zip containers the safe loader
            # rejects; jit.load reads only the graph and the tensors.
            sd = torch.jit.load(path, map_location="cpu").state_dict()
        except Exception:
            # Full unpickling executes code embedded in the file, so it is
            # opt-in only.
            if not os.environ.get("NGPD_UNSAFE_TORCH_LOAD"):
                raise RuntimeError(
                    f"{path} is neither a weights-only checkpoint nor a "
                    "TorchScript archive. Loading it requires full "
                    "unpickling, which executes arbitrary code from the "
                    "file; set NGPD_UNSAFE_TORCH_LOAD=1 only if you "
                    "trust its origin.")
            sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):  # a full module was pickled
        sd = sd.state_dict()
    return dict(sd)


def load_dgcnn_state_dict(path: Union[str, Path]) -> dict:
    """A checkpoint of either lineage -> the port's state dict: ``.npz``
    (Flax variables) or ``.t7`` / ``.pt`` (torch)."""
    if str(path).endswith(".npz"):
        return state_dict_from_variables(load_dgcnn_npz(path))
    return load_torch_checkpoint(path)


_P2N_PARAM = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_P2N_STAT = {"mean": "running_mean", "var": "running_var"}


def patch2normal_state_dict_from_variables(variables: Mapping) -> dict:
    """Flax Patch2Normal variables (numpy) -> the port's state dict."""
    sd: dict = {}
    for key, value in flatten_variables(variables["params"]).items():
        path, leaf = key.rsplit("/", 1)
        v = np.asarray(value, np.float32)
        sd[f"{path.replace('/', '.')}.{_P2N_PARAM[leaf]}"] = v.T if leaf == "kernel" else v
    for key, value in flatten_variables(variables.get("batch_stats", {})).items():
        path, leaf = key.rsplit("/", 1)
        sd[f"{path.replace('/', '.')}.{_P2N_STAT[leaf]}"] = np.asarray(value, np.float32)
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def variables_from_patch2normal_state_dict(state_dict: Mapping) -> dict:
    """The port's Patch2Normal state dict -> Flax variables (numpy), the
    inverse of ``patch2normal_state_dict_from_variables``."""
    stat_of = {v: k for k, v in _P2N_STAT.items()}
    flat: dict = {}
    for key, value in state_dict.items():
        path, attr = key.rsplit(".", 1)
        v = value.detach().cpu().numpy().copy()  # not a view of the live tensor
        path = path.replace(".", "/")
        if attr in stat_of:
            flat[f"batch_stats/{path}/{stat_of[attr]}"] = v
        elif attr == "weight":
            flat[f"params/{path}/" + ("kernel" if v.ndim == 2 else "scale")] = (
                v.T if v.ndim == 2 else v)
        else:
            flat[f"params/{path}/{attr}"] = v
    return unflatten_variables(flat)


def variables_from_state_dict(state_dict: Mapping) -> dict:
    """The port's DGCNN state dict -> Flax DGCNN variables (numpy), the
    inverse of ``state_dict_from_variables``."""
    sd = {k: v.detach().cpu().numpy().copy() for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    params: dict = {}
    stats: dict = {}

    def bn_in(torch_name, p_node, s_node):
        p_node.update(scale=sd[f"{torch_name}.weight"], bias=sd[f"{torch_name}.bias"])
        s_node.update(mean=sd[f"{torch_name}.running_mean"], var=sd[f"{torch_name}.running_var"])

    for i in range(1, _NUM_EDGE_CONVS + 1):
        params[f"conv{i}"] = {"Dense_0": {"kernel": sd[f"conv{i}.0.weight"][:, :, 0, 0].T},
                              "BatchNorm_0": {}}
        stats[f"conv{i}"] = {"BatchNorm_0": {}}
        bn_in(f"bn{i}", params[f"conv{i}"]["BatchNorm_0"], stats[f"conv{i}"]["BatchNorm_0"])
    params["conv7"] = {"kernel": sd["conv7.0.weight"][:, :, 0].T}
    params["linear1"] = {"kernel": sd["linear1.weight"].T}
    for li in (2, 3, 4):
        params[f"linear{li}"] = {"kernel": sd[f"linear{li}.weight"].T,
                                 "bias": sd[f"linear{li}.bias"]}
    for b in (7, 8, 9, 10):
        params[f"bn{b}"], stats[f"bn{b}"] = {}, {}
        bn_in(f"bn{b}", params[f"bn{b}"], stats[f"bn{b}"])
    flat = flatten_variables({"params": params, "batch_stats": stats})
    return unflatten_variables({k: np.ascontiguousarray(v) for k, v in flat.items()})


# BetterDGCNN's modules carry the Flax names, as Patch2Normal's do.
better_dgcnn_state_dict_from_variables = patch2normal_state_dict_from_variables
variables_from_better_dgcnn_state_dict = variables_from_patch2normal_state_dict


def _is_dgcnn(model) -> bool:
    from ..models.dgcnn import DGCNN

    return isinstance(model, DGCNN)


def model_variables(model) -> dict:
    """Flax variables (numpy) of a port DGCNN, BetterDGCNN or Patch2Normal."""
    sd = model.state_dict()
    return (variables_from_state_dict(sd) if _is_dgcnn(model)
            else variables_from_patch2normal_state_dict(sd))


def load_model_variables(model, variables: Mapping):
    """Load Flax variables into a port model, strictly; returns the model."""
    sd = (state_dict_from_variables(variables) if _is_dgcnn(model)
          else patch2normal_state_dict_from_variables(variables))
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


def dgcnn_variables(state) -> dict:
    """``{"params", "batch_stats"}`` of a trained model: a ``TrainState``
    (``learn/train.py``) or the model itself."""
    return model_variables(getattr(state, "model", state))
