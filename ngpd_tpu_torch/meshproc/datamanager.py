"""Mesh session state (torch), as ``ngpd_tpu/meshproc/datamanager.py``, the
C++ app's DataManager (src/GCNDenoiser/GCNDenoiser/DataManager.h:7-42).

Holds the original / noisy / denoised / current meshes of one denoising
session and moves between them, with OBJ import/export
(DataManager::ImportMeshFromFile / ExportMeshToFile; meshes on the CPU). Importing as
original also resets the noisy/denoised/current slots to it, matching
the C++ flow where loading a mesh restarts the session.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from ..io.obj import read_obj, save_obj
from .trimesh import TriMesh

PathLike = Union[str, Path]


class DataManager:
    def __init__(self) -> None:
        self.original: Optional[TriMesh] = None
        self.noisy: Optional[TriMesh] = None
        self.denoised: Optional[TriMesh] = None
        self.mesh: Optional[TriMesh] = None  # the "current" working mesh

    # -- IO (DataManager.h:13-14) --------------------------------------
    def import_mesh(self, path: PathLike, is_original: bool = True) -> TriMesh:
        data = read_obj(str(path))
        if data.fv is None or len(data.fv) == 0:
            raise ValueError(f"{path} has no faces — not a mesh")
        mesh = TriMesh.from_numpy(data.v, data.fv)
        if is_original:
            self.original = mesh
            self.noisy = mesh
            self.denoised = mesh
        else:
            self.noisy = mesh
        self.mesh = mesh
        return mesh

    def export_mesh(self, path: PathLike) -> None:
        if self.mesh is None:
            raise ValueError("no current mesh to export")
        save_obj(str(path), self.mesh.v.cpu().numpy(), faces=self.mesh.f.cpu().numpy())

    # -- slot moves (DataManager.h:25-27) --------------------------------
    def use_noisy(self) -> None:
        self.mesh = self.noisy

    def use_original(self) -> None:
        self.mesh = self.original

    def use_denoised(self) -> None:
        self.mesh = self.denoised

    def clear(self) -> None:
        self.original = self.noisy = self.denoised = self.mesh = None
