"""Every public name of ``ngpd_tpu`` has its counterpart in the port.

Both packages are read with ``ast`` (nothing is imported, so no JAX). For
each module of ``ngpd_tpu/`` (one case each) and each public top-level
function and class in it, one of three holds:

  * the port's module at the same path defines the same name, and the
    port's parameter names include the reference's (a class: its
    ``__init__``'s, else its annotated fields);
  * the name is in ``RENAMED``: the port's counterpart under another name
    or in another module, whose parameters are held the same way;
  * the name is in ``BY_DESIGN``, with the reason it has no single
    counterpart.

A parameter the port leaves out is listed in ``MISSING_ARGS`` with its
reason. An entry of a table that is no longer needed fails as well, so the
tables stay the list of what differs.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "ngpd_tpu"
PORT = ROOT / "ngpd_tpu_torch"
MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))

KEY = "jax.random keys become torch.Generators (the port's draws differ, the distributions do not)"
MODULE = "Flax variables become the torch module, which holds its weights and BatchNorm state"
HELD = "it takes a TrainState, which holds the module and its Adam"

# "reference module::name": ("port module::name", reason)
RENAMED = {
    "core/noise.py::generate_noise": (
        "core/noise.py::apply_noise",
        "the draws (draw_noise, from a torch.Generator) and their application are two functions"),
    "core/pallas_fused.py::pallas_denoise": (
        "core/cuda_fused.py::denoise_passes",
        "the four-pass engine, its Pallas kernels as CUDA kernels (kernels/csrc/pass_*.cu)"),
    "core/pallas_fused.py::pallas_denoise_hybrid": (
        "core/cuda_fused.py::denoise_hybrid",
        "the hybrid engine, its Pallas kernels as CUDA kernels (kernels/csrc/k0-k2.cu)"),
    "learn/torch_interop.py::variables_from_torch_dgcnn": (
        "learn/weights.py::variables_from_state_dict",
        "the port is torch: its weight conversions live together in learn/weights.py"),
    "learn/torch_interop.py::torch_state_dict_from_variables": (
        "learn/weights.py::state_dict_from_variables", "as above"),
    "learn/torch_interop.py::load_torch_checkpoint": (
        "learn/weights.py::load_torch_checkpoint", "as above"),
    "learn/torch_interop.py::load_dgcnn_from_torch": (
        "learn/weights.py::load_dgcnn_state_dict",
        "the port's DGCNN loads a torch state dict directly"),
    "learn/train.py::make_train_step": (
        "learn/train.py::train_step", "torch runs the step eagerly: no step factory to jit"),
    "learn/train.py::make_eval_step": ("learn/train.py::eval_step", "as above"),
    "learn/train.py::make_predict_step": ("learn/train.py::predict_step", "as above"),
    "learn/train_dgcnn.py::make_dgcnn_train_step": (
        "learn/train_dgcnn.py::dgcnn_train_step", "as above"),
    "learn/train_dgcnn.py::make_dgcnn_eval_step": (
        "learn/train_dgcnn.py::dgcnn_eval_step", "as above"),
    "learn/train_dgcnn.py::dgcnn_variables": (
        "learn/weights.py::dgcnn_variables",
        "a state-to-variables conversion, beside the port's other ones"),
    "models/dgcnn.py::dgcnn_from_variables": (
        "models/dgcnn.py::dgcnn_from_state_dict",
        "the port's DGCNN is built from a torch state dict (learn/weights.py converts variables)"),
}

# "reference module::name": reason
BY_DESIGN = {
    "learn/train_dgcnn.py::make_dgcnn_scan_steps": (
        "a lax.scan over a block of jitted steps; the port's fit_dgcnn(scan_steps=) runs "
        "the block's steps in a loop of dgcnn_train_step"),
}

# "port module::name" (after renaming): {reference parameter: reason}
MISSING_ARGS = {
    "core/noise.py::apply_noise": {"key": "it takes draw_noise's draws: " + KEY},
    "core/process.py::preprocess_pointcloud": {"key": KEY},
    "learn/dataset.py::process_cloud": {"key": KEY},
    "meshproc/trimesh.py::add_mesh_noise": {"key": KEY},
    "learn/export.py::export_predict": {"state": MODULE},
    "learn/predict.py::predict_cloud_normals": {"state": MODULE},
    "meshproc/gcn_denoiser.py::predict_face_normals": {"variables": MODULE},
    "meshproc/gcn_denoiser.py::gcn_denoise_mesh": {"variables": MODULE},
    "learn/train.py::TrainState": {
        "params": MODULE, "batch_stats": MODULE,
        "opt_state": "the torch optimiser holds Adam's moments",
        "rng": "a torch.Generator draws the dropout masks"},
    "learn/train.py::init_model": {"rng": "seeded from TrainConfig.seed: " + KEY},
    "learn/train.py::fit": {"model": HELD, "tx": HELD},
    "learn/train_dgcnn.py::init_dgcnn": {
        "rng": "seeded from its seed argument: " + KEY,
        "num_nodes": "Flax needs a dummy input's patch size to build its weights; torch does not"},
    "learn/train_dgcnn.py::fit_dgcnn": {
        "model": HELD, "tx": HELD,
        "train_step": "no step factory: fit_dgcnn calls dgcnn_train_step",
        "eval_step": "no step factory: fit_dgcnn calls dgcnn_eval_step"},
    "models/edgeconv.py::MaskedBatchNorm": {
        "use_running_average": "the module's train() / eval() mode",
        "momentum": "the reference's default 0.9 is the module's constant BN_MOMENTUM",
        "epsilon": "the reference's default 1e-5 is the module's constant BN_EPS"},
    "models/edgeconv.py::EdgeConv": {"train": "the module's train() / eval() mode"},
    "models/edgeconv.py::DynamicEdgeConv": {"train": "the module's train() / eval() mode"},
    "learn/train.py::train_step": {"model": HELD, "tx": HELD},
    "learn/train.py::eval_step": {"model": HELD},
    "learn/train.py::predict_step": {"model": HELD},
    "learn/train_dgcnn.py::dgcnn_train_step": {"model": HELD, "tx": HELD},
    "learn/train_dgcnn.py::dgcnn_eval_step": {"model": HELD},
    "models/dgcnn.py::dgcnn_from_state_dict": {
        "variables": "it takes the torch state dict (learn/weights.py converts variables)"},
    "core/cuda_fused.py::denoise_passes": {
        "interpret": "Pallas's CPU emulation; on CPU tensors the port runs the kernels' "
                     "plain versions (device='cpu')"},
    "core/cuda_fused.py::denoise_hybrid": {"interpret": "as denoise_passes"},
}


def _params(node) -> list[str]:
    if isinstance(node, ast.ClassDef):
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name == "__init__":
                return _params(item)[1:]
        return [item.target.id for item in node.body
                if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name)]
    a = node.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(path: Path) -> dict:
    """{name: parameter names} of the module's top-level functions and
    classes; {} where there is no such module."""
    if not path.is_file():
        return {}
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.name: _params(node) for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _port(qual: str):
    module, name = qual.split("::")
    return _public(PORT / module).get(name)


def _unmapped(module: str) -> list[str]:
    """What the port lacks for ``module``: names and parameters that no
    table explains."""
    problems = []
    for name, ref_params in _public(REF / module).items():
        if name.startswith("_"):
            continue
        qual = f"{module}::{name}"
        if qual in BY_DESIGN:
            continue
        target = RENAMED[qual][0] if qual in RENAMED else qual
        port_params = _port(target)
        if port_params is None:
            problems.append(f"{qual}: no counterpart ({target})")
            continue
        excused = MISSING_ARGS.get(target, {})
        lacking = [p for p in ref_params if p not in port_params and p not in excused]
        if lacking:
            problems.append(f"{qual}: {target} lacks {lacking}")
    return problems


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    assert _unmapped(module) == []


def test_the_tables_list_only_what_differs():
    ref = {f"{m}::{n}": p for m in MODULES for n, p in _public(REF / m).items()}
    for qual, (target, reason) in RENAMED.items():
        assert qual in ref and _port(qual) is None, f"{qual} needs no rename"
        assert _port(target) is not None and reason, qual
    for qual, reason in BY_DESIGN.items():
        assert qual in ref and _port(qual) is None and reason, qual
    sources = {RENAMED.get(q, (q,))[0]: q for q in ref}
    for target, args in MISSING_ARGS.items():
        port_params = _port(target)
        assert target in sources and port_params is not None, target
        for arg, reason in args.items():
            assert arg in ref[sources[target]] and arg not in port_params and reason, \
                f"{target}: {arg}"


def test_every_module_of_the_reference_has_a_port_module():
    missing = [m for m in MODULES if not (PORT / m).is_file()
               and not all(f"{m}::{n}" in RENAMED or f"{m}::{n}" in BY_DESIGN
                           for n in _public(REF / m) if not n.startswith("_"))]
    assert missing == []


def test_the_native_source_has_the_reference_s_c_abi():
    """The C functions that ctypes binds, with the same signatures."""
    def abi(path):
        src = path.read_text()
        body = src[src.index('extern "C" {'):]
        return sorted(" ".join(m.split()) for m in re.findall(
            r"^(?:ObjData\*|int64_t|int|float\*|int32_t\*|void) \w+\([^)]*\)", body, re.M))

    ref = abi(REF / "native" / "ngpd_native.cpp")
    assert len(ref) == 11
    assert abi(PORT / "native" / "ngpd_native.cpp") == ref
