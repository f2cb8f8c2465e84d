"""Builds of the kernels (K0, K1, K2, the hybrid's VU and update stage
kernels, passes A-D and BD, the kNN kernel, the feature kNN, the edge
block and the DGCNN's epilogue) side by side on the card: outputs and
times.

    python -m ngpd_tpu_torch.kernel_lab [--against NAME=CSRC_DIR] ...
        [--kernel NAME] ... [--corner]
        [--rounds 3] [--n 1000000] [--window 128] [--feature-k 32]
        [--smoke-cases] [--sass]

Builds ``k0.cu``, ``k1.cu``, ``k2.cu``, ``hybrid_vu.cu``, ``hybrid_update.cu``,
``pass_a.cu`` ... ``pass_d.cu`` and ``pass_bd.cu`` of this checkout as
they are (the ``tree`` build), and once more for each ``--against`` from
another directory of sources with the same launch interface (an older
checkout's ``csrc``, unpacked with ``git archive``, or a copy of ``csrc``
edited to try a variant), into ``lab/`` of the build cache (``build/lab/``
by default). ``--kernel`` limits the run to the kernels named (default:
all of ``NAMES``).

At the main shapes (``--n`` points of ``bench.make_cloud``, feature_k 32,
tile 256, window 128, default strategy; ``--window`` and ``--feature-k``
change the window and feature_k, e.g. the CLI's 512 and 16, or K0's
shared-memory kernel at 1024 and 2048; the kNN kernel searches the
cloud's feature_k nearest of every point; the feature kNN, the edge
block and the epilogue run on seeded features at the mesh cell's widest
shapes; ``--smoke-cases`` runs the kNN
kernel at every case of ``smoke_cases.knn_kernel_cases`` and the feature kNN at every input
of chip_smoke's ``dgcnn_kernels`` phase instead) it prints one
JSON line a build and kernel (and case): ptxas registers and spills, blocks an SM, whether every output
equals the tree build's bit for bit (rows that differ and the largest
difference otherwise), and the launch time, median of 25 CUDA-event-timed
launches, least and median over ``--rounds`` rounds that take the builds
in turn; a kNN case adds, for the tree build, what its search scanned
(``kernels/knn.py::scan_counts``: tiles taken and chunks scanned, and
those of a full scan). Each pass kernel is fed the plain outputs of the
passes before it, as ``chip_smoke.check_passes`` feeds it. ``--corner`` adds the output
comparison on the 65,536-point corner cloud for all four strategies.
``--sass`` adds, for each build and kernel, the instruction counts of the
entry function's hottest loop (the one with the most float32 arithmetic)
from ``cuobjdump -sass``: its instructions, float arithmetic and
shared-memory loads an iteration, the numerator of the card's issue
ceiling. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
from contextlib import contextmanager
from pathlib import Path

import torch

from . import bench
from . import smoke_cases as sc
from .config import DenoiseConfig
from .core import hybrid_stages as hs
from .core.cuda_fused import passes_prologue, prologue
from .kernels import build
from .kernels import graph as kgraph
from .kernels import hybrid as khy
from .kernels import knn as kknn
from .kernels import passes as kp
from .kernels import window as kw
from .utils.cache import cache_dir

NAMES = ("k0", "k1", "k2", "pass_a", "pass_b", "pass_c", "pass_d", "pass_bd", "knn",
         "feature_knn", "edge_block", "dgcnn_epilogue", "hybrid_vu", "hybrid_update")
STRATEGIES = (("flat", "edge", "feature"), ("new", "corner", "feature"),
              ("dummy", "edge", "corner"), ("flat", "new", "flat"))


def load_builds(against: dict, names=NAMES) -> dict:
    """{build name: {kernel name: (CDLL, library path)}}, all compiled in
    one round of nvcc processes."""
    spec = {"tree": build.CSRC, **{name: Path(csrc).resolve() for name, csrc in against.items()}}
    lab_dir = cache_dir() / "lab"
    paths = {(b, k): build.library_path(k, csrc, lab_dir)
             for b, csrc in spec.items() for k in names}
    build.compile_all({p: spec[b] / f"{k}.cu" for (b, k), p in paths.items()})
    out = {}
    for (b, k), p in paths.items():
        out.setdefault(b, {})[k] = (build.bind_library(k, p), p)
    return out


@contextmanager
def using(libs: dict):
    """Route the wrappers' launches to one build's libraries."""
    saved = dict(build._LIBS)
    build._LIBS.update({k: lib for k, (lib, _) in libs.items()})
    try:
        yield
    finally:
        build._LIBS.clear()
        build._LIBS.update(saved)


def time_launches(fn, reps: int = 25) -> float:
    """Median ms of one launch, each bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _hybrid_state(n: int, cloud, strategy, cfg, window: int):
    """The hybrid engine's prologue state on the card."""
    noisy, nrm, _ = cloud(n)
    return prologue(noisy, nrm, cfg, strategy, window=window, device="cuda")


def k0_call(n: int, cloud, strategy, cfg, window: int = 128):
    st = _hybrid_state(n, cloud, strategy, cfg, window)
    return lambda: (kw.k0(st.pack, st.win, cfg.feature_k, cfg.step_k),)


def k1_call(n: int, cloud, strategy, cfg, window: int = 128):
    st = _hybrid_state(n, cloud, strategy, cfg, window)
    return lambda: (kw.k1(st.pack, st.win, cfg.angle),)


def k2_call(n: int, cloud, strategy, cfg, window: int = 128):
    st = _hybrid_state(n, cloud, strategy, cfg, window)
    pack2 = hs.vu_stage(kw.k1(st.pack, st.win, cfg.angle), st.pack, cfg)
    scal = st.scal.clone()
    scal[1:4, 0] = st.d_thr * torch.tensor([1.0, 2.0, 4.0], device=scal.device)
    nd = len(st.needs_delta)
    return lambda: (kw.k2(pack2, scal, st.win, cfg.angle, strategy, nd),)


def _stage_operands(n: int, cloud, strategy, cfg, window: int):
    """A prologue state, K1's output, the post-VU pack and K2's output: the
    operands of the hybrid's two stage kernels in its first iteration."""
    st = _hybrid_state(n, cloud, strategy, cfg, window)
    t6 = kw.k1(st.pack, st.win, cfg.angle)
    pack2 = hs.vu_stage(t6, st.pack, cfg)
    k2 = kw.k2(pack2, st.scal, st.win, cfg.angle, strategy, len(st.needs_delta))
    return st, t6, pack2, k2


def hybrid_vu_call(n: int, cloud, strategy, cfg, window: int = 128):
    st, t6, _, _ = _stage_operands(n, cloud, strategy, cfg, window)
    return lambda: (khy.vu_stage(t6, st.pack, cfg),)


def hybrid_update_call(n: int, cloud, strategy, cfg, window: int = 128):
    """The update kernel alone, without lag_scal's reduction of its parts."""
    st, _, pack2, k2 = _stage_operands(n, cloud, strategy, cfg, window)
    return lambda: khy.update_kernel(k2, pack2, st.d_thr, cfg, strategy, st.needs_delta,
                                     st.lay, st.win.nv)


def _pass_a_state(n: int, cloud, strategy, cfg, window: int):
    """The pass engine's prologue state on the card and the plain pass A's
    packs."""
    noisy, nrm, _ = cloud(n)
    st = passes_prologue(noisy, nrm, cfg, strategy, window=window, device="cuda")
    return st, *kp.pass_a_plain(st.gq, st.gr, st.win, cfg)


def a_call(n: int, cloud, strategy, cfg, window: int = 128):
    noisy, nrm, _ = cloud(n)
    st = passes_prologue(noisy, nrm, cfg, strategy, window=window, device="cuda")
    return lambda: kp.pass_a(st.gq, st.gr, st.win, cfg)


def b_call(n: int, cloud, strategy, cfg, window: int = 128):
    st, gq2, gr2 = _pass_a_state(n, cloud, strategy, cfg, window)
    return lambda: kp.pass_b(gq2, gr2, st.win, cfg, st.needs_delta)


def c_call(n: int, cloud, strategy, cfg, window: int = 128):
    """Pass C's call, or None where the strategy has no delta class."""
    st, gq2, gr2 = _pass_a_state(n, cloud, strategy, cfg, window)
    win, nd = st.win, st.needs_delta
    if not nd:
        return None
    cls, parts = kp.pass_b_plain(gq2, gr2, win, cfg, nd)
    scal = kp.delta_scal(st.d_thr, parts)
    return lambda: (kp.pass_c(gq2, gr2, cls, scal, win, nd),)


def d_call(n: int, cloud, strategy, cfg, window: int = 128):
    st, gq2, gr2 = _pass_a_state(n, cloud, strategy, cfg, window)
    win, nd = st.win, st.needs_delta
    cls, parts = kp.pass_b_plain(gq2, gr2, win, cfg, nd)
    scal = kp.delta_scal(st.d_thr, parts)
    if nd:
        scal = kp.delta_scal(st.d_thr, parts, kp.pass_c_plain(gq2, gr2, cls, scal, win, nd))
    return lambda: (kp.pass_d(gq2, gr2, cls, scal, win, cfg, strategy, nd),)


def bd_call(n: int, cloud, strategy, cfg, window: int = 128):
    noisy, nrm, _ = cloud(n)
    st = passes_prologue(noisy, nrm, cfg, strategy, window=window, device="cuda")
    win, nd = st.win, st.needs_delta
    gq2, gr2 = kp.pass_a(st.gq, st.gr, win, cfg)
    first = kp.initial_lag_scal(st.gq[0:3], win.nv, len(nd), st.d_thr)
    lag = kp.lag_scal(st.d_thr, kp.pass_bd(gq2, gr2, first, win, cfg, strategy, nd)[3])
    for ci in range(len(nd)):
        lag[1 + ci, 0] = st.d_thr * 2.0 ** ci
    return lambda: kp.pass_bd(gq2, gr2, lag, win, cfg, strategy, nd)


def knn_call(n: int, cloud, strategy, cfg, window: int = 128):
    from .ops.knn import knn

    pts = torch.as_tensor(cloud(n)[0], device="cuda")

    def call():
        nbh, d = knn(pts, cfg.feature_k)
        return nbh.idx, d
    return call


# The graph kernels at the mesh cell's widest shapes: a DGCNN batch of
# patches (64 nodes, C 256), the feature kNN's k 8, the edge block's and the
# epilogue's K 8.
GRAPH_P, GRAPH_C, GRAPH_K = 64, 256, 8


def _graph_features(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((bench.MESH_BATCH, GRAPH_P, GRAPH_C), generator=g).to("cuda")


def feature_knn_call(n: int, cloud, strategy, cfg, window: int = 128):
    x = _graph_features()
    return lambda: (kgraph.feature_knn(x, GRAPH_K),)


def edge_block_call(n: int, cloud, strategy, cfg, window: int = 128):
    x = _graph_features()
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, GRAPH_P, (bench.MESH_BATCH, GRAPH_P, GRAPH_K), generator=g).to("cuda")
    return lambda: (kgraph.edge_block(x, idx, "dgcnn"),)


def dgcnn_epilogue_call(n: int, cloud, strategy, cfg, window: int = 128):
    """The epilogue of a feature-kNN conv's (B, 64, 8, 256) product with
    seeded BatchNorm terms, multipliers of both signs."""
    g = torch.Generator().manual_seed(2)
    h = torch.randn((bench.MESH_BATCH, GRAPH_P, GRAPH_K, GRAPH_C), generator=g).to("cuda")
    mean, mul, bias = (torch.randn((GRAPH_C,), generator=g).to("cuda") for _ in range(3))
    return lambda: (kgraph.dgcnn_epilogue(h, mean, mul, bias, GRAPH_K),)


def smoke_runs() -> list:
    """(kernel, case, k, call maker) for every input chip_smoke holds the kNN
    kernels to (``smoke_cases``): every case of its ``knn_kernel`` phase,
    then the feature kNN's integer features at C 128 and 256 and the mesh
    cell's activations."""
    from .config import PatchConfig
    from .models import dgcnn
    from .ops.knn import knn, nn_distances

    runs = [("knn", c["case"], c["k"],
             (lambda c=c: lambda: sc.run_knn_case(c, knn, nn_distances, "cuda")))
            for c in sc.knn_kernel_cases()]
    g = torch.Generator().manual_seed(0)
    p = PatchConfig().num_nodes
    xs = [(f"int_c{c}", sc.int_features(bench.MESH_BATCH, p, c, g).to("cuda"))
          for c in sc.FKNN_WIDTHS]
    xs += [(f"conv{4 + i}_c{x.shape[2]}", x) for i, x in enumerate(
        sc.mesh_activations("cuda", sc.MESH_SUBDIV, bench.MESH_BATCH))]
    return runs + [("feature_knn", name, sc.FKNN_K,
                    (lambda x=x: lambda: (dgcnn.feature_knn(x, sc.FKNN_K),)))
                   for name, x in xs]


def _k0_entry(wt_c: int, feature_k: int) -> tuple:
    """K0's register kernel takes its columns a lane; past 2,048 columns
    its shared-memory kernel runs."""
    lanes = kw.k0_lanes(wt_c)
    return ("k0_kernel", (lanes,)) if lanes <= 64 else ("k0_wide_kernel", ())


def _knn_entry(wt_c: int, feature_k: int) -> tuple:
    """The kNN kernel's variant follows k (feature_k): its queries a
    thread and whether its list is one key."""
    return "knn_kernel", kknn.variant(feature_k)


def _window(*extra):
    """``ngpd_<name>_blocks_per_sm``'s arguments: the tile, the window
    columns, then ``extra``."""
    return lambda tile, wt_c, feature_k: (tile, wt_c, *extra)


# Each kernel's call at the main shapes, its entry function in the ptxas
# report (the template arguments of the variant the main shapes launch;
# SHAPED_ENTRIES picks the variant of kernels whose variant follows the
# window or k, ``entry_of``) and the arguments of its
# ``ngpd_<name>_blocks_per_sm`` as a function of (tile, window columns, k).
CALLS = {"k0": k0_call, "k1": k1_call, "k2": k2_call, "pass_a": a_call, "pass_b": b_call,
         "pass_c": c_call, "pass_d": d_call, "pass_bd": bd_call, "knn": knn_call,
         "feature_knn": feature_knn_call, "edge_block": edge_block_call,
         "dgcnn_epilogue": dgcnn_epilogue_call, "hybrid_vu": hybrid_vu_call,
         "hybrid_update": hybrid_update_call}
ENTRIES = {"k0": ("k0_kernel", (16,)), "k1": ("k1_kernel", ()),
           "k2": ("k2_kernel", (True, True, False)), "pass_a": ("pass_a_kernel", ()),
           "pass_b": ("pass_b_kernel", (True,)), "pass_c": ("pass_c_kernel", ()),
           "pass_d": ("pass_d_kernel", ()), "pass_bd": ("pass_bd_kernel", (True,)),
           "knn": ("knn_kernel", kknn.variant(32)),
           "feature_knn": ("feature_knn_kernel", (8, True, True)),
           "edge_block": ("edge_block_kernel", (True,)),
           "dgcnn_epilogue": ("dgcnn_epilogue_kernel", (GRAPH_K, 4)),
           "hybrid_vu": ("hybrid_vu_kernel", ()), "hybrid_update": ("hybrid_update_kernel", ())}
SHAPED_ENTRIES = {"k0": _k0_entry, "knn": _knn_entry}
GEOMETRY = {"k0": _window(), "k1": _window(), "k2": _window(1, 1, 0), "pass_a": _window(),
            "pass_b": _window(), "pass_c": _window(), "pass_d": _window(),
            "pass_bd": _window(), "knn": lambda tile, wt_c, feature_k: (feature_k,),
            "feature_knn": lambda tile, wt_c, feature_k: (GRAPH_P, GRAPH_C, GRAPH_K),
            "edge_block": lambda tile, wt_c, feature_k: (GRAPH_C,),
            "dgcnn_epilogue": lambda tile, wt_c, feature_k: (GRAPH_K, GRAPH_C),
            "hybrid_vu": lambda tile, wt_c, feature_k: (),
            "hybrid_update": lambda tile, wt_c, feature_k: ()}


def entry_of(kernel: str, wt_c: int = 512, feature_k: int = 32) -> tuple:
    """The entry function and template arguments ``kernel`` launches at
    ``wt_c`` window columns and k ``feature_k``."""
    shaped = SHAPED_ENTRIES.get(kernel)
    return shaped(wt_c, feature_k) if shaped else ENTRIES[kernel]


FP32_OPS = ("FADD", "FMUL", "FMNMX", "FFMA", "FSETP", "FSEL")


def sass_hot_loop(library: Path, function_tag: str) -> dict:
    """The hot loop of ``library``'s first entry function whose name holds
    ``function_tag``, from ``cuobjdump -sass`` (a loop runs from a backward
    branch's target to the branch): the smallest loop that holds a warp
    vote (the kNN kernel's batch loop; ``to_vote`` counts its instructions
    from the loop head through the vote's branch, the path of a batch that
    no query takes), else the innermost loop with the most float32
    instructions. Counts its instructions, float32 instructions and LDS."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    body = next((f for f in text.split("Function : ")[1:]
                 if function_tag in f.split("\n", 1)[0]), "")
    instr = []  # (address, opcode)
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            words = m.group(2).split()
            branch = re.search(r"BRA .*?0x([0-9a-f]+)", m.group(2))
            instr.append((int(m.group(1), 16), words[1] if words[0].startswith("@") else words[0],
                          int(branch.group(1), 16) if branch else None))
    loops = [(t, a) for a, _, t in instr if t is not None and t < a]

    def ops(lo, hi):
        return [o for a, o, _ in instr if lo <= a <= hi]

    voted = [lp for lp in loops if any(o.startswith("VOTE") for o in ops(*lp))]
    if voted:
        lo, hi = min(voted, key=lambda lp: lp[1] - lp[0])
    else:
        inner = [lp for lp in loops if not any(lp[0] <= t and a < lp[1] for t, a in loops
                                               if (t, a) != lp)]
        if not inner:
            return {}
        lo, hi = max(inner, key=lambda lp: sum(o.startswith(FP32_OPS) for o in ops(*lp)))
    loop = ops(lo, hi)
    rec = {"instructions": len(loop), "fp32": sum(o.startswith(FP32_OPS) for o in loop),
           "lds": sum(o.startswith("LDS") for o in loop), "from": hex(lo), "to": hex(hi)}
    if voted:
        vote = loop.index(next(o for o in loop if o.startswith("VOTE")))
        rec["to_vote"] = vote + 2  # the vote and its branch
    return rec


def compare(got, want) -> dict:
    """Whether two tuples of tensors are equal element for element, the
    rows (or, of a vector, the count) that differ and the largest gap."""
    rows, worst = [], 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        bad = (g != w) & ~(torch.isnan(g) & torch.isnan(w))  # NaN equals NaN here
        if bool(bad.any()):
            rows.append([k, bad.reshape(bad.shape[0], -1).any(dim=1).nonzero()[:, 0].tolist()
                         if bad.dim() > 1 else int(bad.sum())])
            worst = max(worst, float((g - w).abs().nan_to_num().max()))
    return {"equal": not rows, "differing_rows": rows, "max_abs_diff": worst}


def ptxas_of(kernel: str, library: Path, wt_c: int = 512, feature_k: int = 32) -> dict:
    report = build.ptxas_report(library)
    name, flags = entry_of(kernel, wt_c, feature_k)
    # Older sources may build the kernel without its template flags.
    entry = build.template_entry(report, name, *flags) or next(
        (r for r in report if name in r["function"]), {})
    return {k: v for k, v in entry.items() if k != "function"}


def blocks_per_sm(kernel: str, lib, tile: int = 256, wt_c: int = 512,
                  feature_k: int = 32) -> int | None:
    fn = getattr(lib, f"ngpd_{kernel}_blocks_per_sm", None)
    return None if fn is None else fn(*GEOMETRY[kernel](tile, wt_c, feature_k))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ngpd_tpu_torch.kernel_lab")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=CSRC_DIR")
    ap.add_argument("--kernel", action="append", choices=NAMES, default=[])
    ap.add_argument("--corner", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--feature-k", type=int, default=32)
    ap.add_argument("--smoke-cases", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_lab needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = tuple(args.kernel) or NAMES
    builds = load_builds(dict(a.split("=", 1) for a in args.against), names)
    cfg = DenoiseConfig(feature_k=args.feature_k, step_k=8)
    wt_c = 256 + 2 * args.window  # tile 256, sub 8: the hybrid's window columns

    cased = {"knn", "feature_knn"} if args.smoke_cases else set()
    runs = [(kernel, None, None, None) for kernel in names if kernel not in cased]
    if args.smoke_cases:
        runs += [r for r in smoke_runs() if r[0] in names]
    for kernel, case, k, make in runs:
        call = (make() if case else
                CALLS[kernel](args.n, bench.make_cloud, STRATEGIES[0], cfg, args.window))
        k = k or args.feature_k
        kknn.reset_launch_counts()
        with using(builds["tree"]):
            want = call()
        scan = {"scan": kknn.scan_counts()} if kernel == "knn" and case else {}
        outs = {}
        for b, libs in builds.items():
            with using(libs):
                outs[b] = compare(call(), want)
        times = {b: [] for b in builds}
        for _ in range(args.rounds):
            for b, libs in builds.items():
                with using(libs):
                    times[b].append(time_launches(call))
        for b, libs in builds.items():
            print(json.dumps({"kernel": kernel, "case": case, "build": b,
                              "n": args.n, "window": args.window,
                              "feature_k": k,
                              **ptxas_of(kernel, libs[kernel][1], wt_c, k),
                              "blocks_per_sm": blocks_per_sm(kernel, libs[kernel][0], 256, wt_c,
                                                             k),
                              **outs[b], **(scan if b == "tree" else {}),
                              "ms_min": min(times[b]),
                              "ms_median": statistics.median(times[b]),
                              **({"hot_loop": sass_hot_loop(libs[kernel][1], build.template_tag(
                                  *[entry_of(kernel, wt_c, k)[0]], *entry_of(kernel, wt_c, k)[1]))}
                                 if args.sass else {})}),
                  flush=True)

    if args.corner:
        for strategy in STRATEGIES:
            for kernel in names:
                if kernel in ("k0", "k1", "knn", "feature_knn", "edge_block", "dgcnn_epilogue",
                              "hybrid_vu") \
                        and strategy != STRATEGIES[0]:
                    continue  # the strategy does not reach these kernels' inputs
                call = CALLS[kernel](65_536, bench.make_corner_cloud, strategy, cfg,
                                     args.window)
                if call is None:  # pass C of a strategy without a delta class
                    continue
                with using(builds["tree"]):
                    want = call()
                for b, libs in builds.items():
                    if b == "tree":
                        continue
                    with using(libs):
                        print(json.dumps({"kernel": kernel, "build": b, "cloud": "corner 65536",
                                          "strategy": strategy, **compare(call(), want)}),
                              flush=True)


if __name__ == "__main__":
    main()
