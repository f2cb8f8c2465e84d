"""The one generator of the benchmark's inputs: a traffic mix's data file
names a shape and its parameters, and ``make_pool`` draws the mix's pool of
inputs from the seed.

Every input of a pool has the same sizes; the seed changes the noise, not
the work. The window's jobs take the pool's inputs in turn.
"""

from __future__ import annotations

import torch

from . import shapes


def _cloud(traffic: dict, gen, device, fn) -> dict:
    noisy, normals, clean = fn(int(traffic["points"]), float(traffic["noise"]), gen, device)
    return {"points": noisy, "normals": normals, "clean": clean}


def _mesh(traffic: dict, gen, device) -> dict:
    noisy, faces, clean = shapes.noisy_icosphere(int(traffic["subdiv"]), float(traffic["radius"]),
                                                 float(traffic["noise"]), gen, device)
    return {"vertices": noisy, "faces": faces, "clean": clean}


SHAPES = {
    "roof_cloud": lambda t, g, d: _cloud(t, g, d, shapes.roof_cloud),
    "corner_cloud": lambda t, g, d: _cloud(t, g, d, shapes.corner_cloud),
    "icosphere_mesh": _mesh,
}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``: any whole number
    that 64 bits hold, negative ones included."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def make_pool(traffic: dict, seed: int, device) -> list[dict]:
    """The mix's ``pool`` inputs, drawn in turn from one generator seeded
    with ``seed``, on ``device``."""
    make = SHAPES[traffic["shape"]]
    gen = generator(seed, device)
    return [make(traffic, gen, device) for _ in range(int(traffic["pool"]))]
