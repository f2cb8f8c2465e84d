"""The port's ``apps/viz.py`` and ``utils/`` against ``ngpd_tpu``'s.

The plots are rendered by both packages from the same inputs (those of the
reference's ``test_viz_outputs``) and compared pixel for pixel; the port's
take numpy arrays and tensors alike. ``utils/prof.py`` times and traces
with torch; ``utils/cache.py`` places the port's compiled libraries (the
CUDA kernels and the native runtime), its counterpart of the reference's
JAX compilation cache.
"""

import os

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from ngpd_tpu.apps import viz as jviz
from ngpd_tpu_torch import native
from ngpd_tpu_torch.apps import viz
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.utils import Timer, cache, profile_trace, time_fn

from fixtures import sphere_cloud

torch.set_num_threads(2)

ROOT = build.BUILD_DIR.parents[1]


def _unset(monkeypatch):
    """Unset the override for this test, restored on the way out (setenv
    first, so that the undo also removes a value set by the test)."""
    monkeypatch.setenv(cache.ENV_VAR, "")
    monkeypatch.delenv(cache.ENV_VAR)


def _inputs():
    pts, nrm = sphere_cloud(200, seed=7)
    cls = np.random.default_rng(0).integers(0, 3, len(pts))
    eigval = np.abs(np.random.default_rng(1).normal(size=(len(pts), 3)))
    eigvec = np.tile(np.eye(3), (len(pts), 1, 1))
    return pts, nrm, cls, eigval, eigvec


def _plots(mod, args, tmp, tag):
    pts, nrm, cls, eigval, eigvec = args
    return {
        "cloud": mod.plot_cloud(pts, normals=nrm, out=tmp / f"{tag}_c.png"),
        "classes": mod.plot_classes(pts, cls, out=tmp / f"{tag}_cls.png"),
        "voting": mod.plot_tensor_voting(pts, eigval, eigvec, out=tmp / f"{tag}_tv.png"),
    }


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_plots_are_pixel_equal_to_the_reference(tmp_path, as_tensor):
    args = _inputs()
    want = _plots(jviz, args, tmp_path, "ref")
    if as_tensor:
        args = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    got = _plots(viz, args, tmp_path, "port")
    for name in want:
        assert got[name].exists() and got[name].stat().st_size > 1000
        a, b = mpimg.imread(got[name]), mpimg.imread(want[name])
        assert a.shape == b.shape and np.array_equal(a, b), name


def test_viz_keeps_the_reference_s_colours():
    np.testing.assert_array_equal(viz.CLASS_COLORS, jviz.CLASS_COLORS)


def test_timer_records_the_elapsed_time(capsys):
    with Timer("phase") as t:
        sum(range(10_000))
    assert t.elapsed > 0.0
    assert capsys.readouterr().out.startswith("[phase] ")
    with Timer(verbose=False) as quiet:
        pass
    assert quiet.elapsed >= 0.0 and capsys.readouterr().out == ""


def test_time_fn_calls_warmup_plus_repeats():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"out": [torch.full((4,), x * scale)], "n": (len(calls),)}

    best = time_fn(fn, 3.0, repeats=4, warmup=2, scale=2.0)
    assert isinstance(best, float) and best > 0.0
    assert calls == [3.0] * 6
    calls.clear()
    time_fn(fn, 1.0)
    assert len(calls) == 4


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert log_dir == str(tmp_path / "trace")
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "traceEvents" in files[0].read_text()


def test_default_cache_dir_is_the_checkout_s_build(monkeypatch):
    _unset(monkeypatch)
    assert cache.default_cache_dir() == str(ROOT / "build")
    assert cache.cache_dir() == ROOT / "build"
    assert build.build_dir() == build.BUILD_DIR
    assert build.library_path("k1").parent == build.BUILD_DIR


def test_enable_compilation_cache_argument_and_override(monkeypatch, tmp_path):
    _unset(monkeypatch)
    assert cache.enable_compilation_cache(str(tmp_path / "a")) == str(tmp_path / "a")
    assert build.library_path("k2").parent == tmp_path / "a" / "kernels"
    assert native.library_path().parent == tmp_path / "a" / "native"
    # An explicit environment variable wins over the argument.
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "env"))
    assert cache.enable_compilation_cache(str(tmp_path / "b")) == str(tmp_path / "env")
    assert build.library_path("k0").parent == tmp_path / "env" / "kernels"
    monkeypatch.delenv(cache.ENV_VAR)
    assert cache.enable_compilation_cache() == cache.default_cache_dir()
    assert os.environ[cache.ENV_VAR] == cache.default_cache_dir()


def test_the_native_build_follows_the_override(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    flags, cxx = native.FLAG_SETS[-1], native.compilers()[-1]
    path = native._build(flags, cxx)
    assert path == tmp_path / "native" / native.library_path(flags, cxx).name
    assert path.is_file() and not list(path.parent.glob("*.tmp*"))
    # The same source and flags give the same name; other flags another.
    assert native.library_path(flags, cxx) == path
    assert native.library_path(native.FLAG_SETS[0], cxx) != path
    assert native.library_path(flags, "/other/g++") != path


def test_the_cli_enables_the_cache_first(monkeypatch, tmp_path):
    from ngpd_tpu_torch.apps import cli

    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert os.environ[cache.ENV_VAR] == str(tmp_path)
    monkeypatch.delenv(cache.ENV_VAR)
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert os.environ[cache.ENV_VAR] == cache.default_cache_dir()


def test_importing_the_port_builds_nothing_and_loads_no_matplotlib(tmp_path):
    """Every module of the port but ``apps/viz.py`` imports without
    matplotlib and without building a library (the build cache, moved to an
    empty directory, stays empty)."""
    import subprocess
    import sys

    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "ngpd_tpu_torch").rglob("*.py") if p.name != "viz.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n")
    env = {**os.environ, cache.ENV_VAR: str(tmp_path / "cache")}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=300)
    assert not (tmp_path / "cache").exists()
