"""Compute the JAX package's answer to each numpy-seeded cell of
``chip_smoke.py`` on the CPU and keep it in ``jax_reference/``.

    JAX_PLATFORMS=cpu python scripts/make_jax_reference.py [--cell NAME ...]

Each cell is one fleet or one solve that ``chip_smoke.py`` runs on the
card, at the phase's full size, dtype and configuration (the constants are
``chip_smoke``'s own, imported from it).  Its instances are drawn by the
port's numpy samplers and handed to the JAX package as arrays, the way
``tests/fleet_parity_common.py`` hands them over.  The fleets of phases 4,
10 and 16 take the JAX package's TPU dispatch: the Pallas factor and solve
kernels for float32 systems of n <= 64, run in interpret mode
(``fleet_parity_common.kernel_path``; at n > 64 that dispatch is the CPU
path's, and the manifest's ``pallas_interpret_reached`` says whether a
kernel was reached).  The wide portfolios and the dense NLPs, whose TPU
dispatch would reach Pallas kernels that no switch here turns on, take the
JAX CPU path, and the manifest says so.  So do the float64 cells of phase
27 (``chip_smoke.F64_CELLS``: each the float32 cell of the same name with
``float_dtype="float64"``, drawn in float64 by ``chip_smoke.twin_arrays``):
the JAX package's lane dispatch sends only float32 to its kernels
(``pyipm_tpu/ops/pallas_ldlt.py:319-329``), so its CPU path is its float64
path on any backend; their entries carry the sha256 of every input array,
and their files the x of rows 0-127 and the named rows only.  The Schur solves of phases 21-25
(``chip_smoke.BLOCK_CELLS``) are drawn by ``chip_smoke.draw_block`` (the
port's numpy samplers, exact on any machine) and solved by the JAX
package's ``make_separable_solver`` or ``make_block_solver`` on a
one-device mesh: the TPU dispatch where their float32 condensed blocks
reach the Pallas factor (n <= 64), the CPU path otherwise (float64, d =
1024, the L-BFGS mode).

Each cell runs in its own process (x64 mode is process-wide and the
float64 cell turns it on) and writes ``jax_reference/<cell>.npz``:
``signal`` (int8), ``iter_count`` (int16) and ``f`` (float64) of every
instance, ``x`` (the cell's dtype) of the rows in ``x_rows`` (rows 0-511
and the instances ``chip_smoke.py`` or the parity tests name), ``kkt``
(float64) where the cell is one solve; a Schur cell keeps its one
solve's ``signal``, ``iter_count``, ``f``, ``kkt``, the coupling
multipliers ``lc`` and ``lci`` and the x of ``chip_smoke.block_x_layout``
(whole blocks up to 16,384 values, or the first 16,384 / K entries of
every block); and its entry in ``jax_reference/MANIFEST.json``: sampler,
seed, sizes, dtype, configuration, the JAX path, the rows of x (a Schur
cell: its x layout and the sha256 of every input array), the JAX
version, the wall and the file's sha256.  ``chip_smoke.hold_to_jax`` and
``chip_smoke.hold_block_to_jax`` hold the card to these files.
``--cell`` regenerates one cell (cells run one after another: each
rewrites the manifest).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
import zipfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fleet_parity_common as fp  # noqa: E402

OUT = os.path.join(ROOT, "jax_reference")
KTOL = 1e-4
X_ROWS = 512                 # x of rows 0-511 of every fleet
# instances that chip_smoke.py, ROADMAP Queue 3 or the fleet parity tests
# name (SVM 524 stops apart from the CPU path on the card)
NAMED_ROWS = dict(mixed_maxent=fp.MAXENT_CARD_SPLIT, mixed_svm=(524,),
                  mixed_mpc=fp.MPC_JAX_CPU_FAILS + fp.MPC_SLOW)
KERNEL, CPU = "tpu_dispatch_interpret", "cpu"
FAMILIES = ("portfolio", "svm", "maxent", "mpc")
FLEET_CELLS = ("qp_adaptive", "qp_mehrotra",
               *(f"mixed_{b}" for b in FAMILIES), "mixed_box_qp",
               "wide_portfolio", "dense_condensed", "dense_ldlt",
               "dense_lbfgs", *cs.F64_CELLS)
# the float64 cells keep the x of rows 0-127 and the named rows (their
# x is twice the bytes, and jax_reference/ stays within 3 MB)
X_ROWS_F64 = 128
# the Schur solves of phases 21-25, one a cell (chip_smoke.BLOCK_CELLS)
BLOCK_CELLS = tuple(cs.BLOCK_CELLS)
CELLS = FLEET_CELLS + BLOCK_CELLS
# the numpy sampler and the JAX solver of each Schur family
BLOCK_SAMPLERS = dict(
    separable="pyipm_tpu_torch.parallel.schur.sample_separable_arrays",
    resource="pyipm_tpu_torch.models.applications."
    "sample_resource_alloc_arrays",
    general="pyipm_tpu_torch.parallel.schur.sample_block_general_arrays",
    ragged="pyipm_tpu_torch.parallel.schur.sample_block_ragged_arrays",
    box_quadratic="pyipm_tpu_torch.parallel.schur."
    "sample_block_box_quadratic_arrays")
BLOCK_SOLVERS = dict(
    separable="pyipm_tpu.parallel.schur.make_separable_solver (the spec "
    "of pyipm_tpu.parallel.schur.sample_separable)",
    resource="pyipm_tpu.parallel.schur.make_block_solver(pyipm_tpu.models."
    "applications.make_resource_alloc_spec)",
    general="pyipm_tpu.parallel.schur.make_block_solver (the spec of "
    "pyipm_tpu.parallel.schur.sample_block_general)",
    ragged="pyipm_tpu.parallel.schur.make_block_solver (the spec of "
    "pyipm_tpu.parallel.schur.sample_block_ragged)",
    box_quadratic="pyipm_tpu.parallel.schur.make_block_solver (the spec "
    "of benchmarks/bench_lbfgs_block.py:48-70)")


def block_kernel_path(cell):
    """Whether a Schur cell's JAX solve takes the TPU dispatch: a float32
    exact-Hessian solve whose condensed blocks (n = d + me) the Pallas
    factor takes (n <= 64)."""
    c = cs.BLOCK_CELLS[cell]
    n = c["instance"]["d"] + c["instance"].get("me", c["instance"].get(
        "neq", 0))
    return (c["config"]["float_dtype"] == "float32"
            and not c["config"].get("lbfgs") and n <= 64)


def spec(cell):
    """What ``cell`` is, from chip_smoke's constants: the manifest keys that
    tests/test_torch_jax_reference.py holds to the constants."""
    f32 = dict(float_dtype="float32", verbosity=0, Ktol=KTOL)
    if cell in cs.BLOCK_CELLS:
        c = cs.BLOCK_CELLS[cell]
        return dict(phase=c["phase"], instances=1,
                    sampler=BLOCK_SAMPLERS[c["family"]], seed=c["seed"],
                    sizes=c["instance"],
                    x0="ones" if c["family"] == "resource" else "zeros",
                    config=c["config"],
                    jax_path=KERNEL if block_kernel_path(cell) else CPU,
                    jax_solver=BLOCK_SOLVERS[c["family"]])
    if cell in cs.F64_CELLS:
        # the JAX package's lane dispatch takes float32 only
        # (pallas_ldlt.py:323), so its float64 path is the CPU path's on
        # any backend
        twin = spec(cell.removesuffix("_f64"))
        return dict(twin, phase=27, jax_path=CPU, config=dict(
            twin["config"], float_dtype="float64"))
    if cell.startswith("qp_"):
        mu = cell.removeprefix("qp_")
        return dict(phase=4 if mu == "adaptive" else 10, instances=cs.B,
                    sampler="pyipm_tpu_torch.models.random_nlp."
                    "sample_qp_arrays", seed=cs.SEED,
                    sizes=dict(B=cs.B, D=cs.D, nlin=cs.NLIN),
                    x0=f"chip_smoke.qp_x0 (seed {cs.QP_X0_SEED})",
                    config=dict(f32, mu_strategy=mu), jax_path=KERNEL,
                    jax_solver="pyipm_tpu.models.random_nlp."
                    "make_qp_batch_solver")
    if cell == "mixed_box_qp":
        return dict(phase=16, instances=cs.MIXED["box"],
                    sampler="examples/heterogeneous_fleet.py box_qp(BOX_D, "
                    "SEED + i) (the port's box_qp_data)", seed=cs.SEED,
                    sizes=dict(B=cs.MIXED["box"], D=cs.BOX_D), x0="zeros",
                    config=f32, jax_path=KERNEL,
                    jax_solver="pyipm_tpu.parallel.fleet.solve_fleet")
    if cell.startswith("mixed_"):
        name = cell.removeprefix("mixed_")
        n = cs.MIXED[name]
        sizes = dict(portfolio=dict(B=n, D=cs.PORTFOLIO_D),
                     svm=dict(B=n, npoints=cs.SVM_N, nfeat=cs.SVM_FEAT),
                     maxent=dict(B=n, D=cs.MAXENT_D, m=cs.MAXENT_M),
                     mpc=dict(B=n, nx=cs.MPC_NX, nu=cs.MPC_NU, T=cs.MPC_T))
        return dict(phase=16, instances=n,
                    sampler=f"pyipm_tpu_torch.models.applications.sample_"
                    f"{name}_arrays", seed=cs.SEED, sizes=sizes[name],
                    x0=f"pyipm_tpu_torch.models.applications.{name}_x0",
                    config=f32, jax_path=KERNEL,
                    jax_solver=f"pyipm_tpu.models.applications.make_{name}"
                    "_batch_solver")
    if cell == "wide_portfolio":
        W = cs.WIDE_PORTFOLIO
        return dict(phase=26, instances=cs.WIDE_JAX_ROWS,
                    sampler="pyipm_tpu_torch.models.applications."
                    "sample_portfolio_arrays (rows 0 to instances - 1)",
                    seed=cs.SEED, sizes=dict(B=W["B"], D=W["D"]),
                    x0="pyipm_tpu_torch.models.applications.portfolio_x0",
                    config=f32, jax_path=CPU,
                    jax_solver="pyipm_tpu.models.applications."
                    "make_portfolio_batch_solver")
    dense = dict(phase=8, instances=1,
                 sampler="pyipm_tpu_torch.models.random_nlp."
                 "sample_dense_arrays", jax_path=CPU,
                 jax_solver="pyipm_tpu.models.random_nlp."
                 "make_dense_nlp_solver")
    if cell == "dense_lbfgs":
        return dict(dense, phase=11, seed=cs.LBFGS_SEED,
                    sizes=dict(D=cs.LBFGS_D, M=cs.LBFGS_M, hidden=cs.DENSE_H),
                    x0="zeros", config=dict(cs.LBFGS_CFG, verbosity=0))
    return dict(dense, seed=cs.DENSE_SEED,
                sizes=dict(D=cs.DENSE_D, M=cs.DENSE_M, hidden=cs.DENSE_H),
                x0=f"{cs.DENSE_X0} * ones",
                config=dict(f32, linear_solver=cell.removeprefix("dense_")))


def _solver(cell):
    """``solve(rows)``: the JAX package's batched result of ``rows`` of
    ``cell`` (a SolverResult of (len(rows), ...) arrays), on the numpy
    instances of ``chip_smoke.twin_arrays`` (``dense_lbfgs``: phase 11's
    draw)."""
    import jax
    import jax.numpy as jnp

    from pyipm_tpu import IPMConfig as JCfg

    sp = spec(cell)
    dt = np.dtype(sp["config"]["float_dtype"])
    if dt == np.float64:
        jax.config.update("jax_enable_x64", True)
    cfg = JCfg(**sp["config"])
    base = cell.removesuffix("_f64")
    arr = cs.twin_arrays(cell) if base in cs.F64_TWINS else None
    if base.startswith("qp_"):
        from pyipm_tpu.models.random_nlp import QPData, make_qp_batch_solver
        x0 = cs.qp_x0().astype(dt)
        fn = make_qp_batch_solver(cfg, cs.D, cs.NLIN)
        return (lambda rows: fn(jnp.asarray(x0[rows]), QPData(
            *(jnp.asarray(arr[k][rows]) for k in QPData._fields))))
    if base == "mixed_box_qp":
        from pyipm_tpu.parallel.fleet import solve_fleet
        path = os.path.join(ROOT, "examples", "heterogeneous_fleet.py")
        mod = importlib.util.spec_from_file_location("heterogeneous_fleet",
                                                     path)
        ex = importlib.util.module_from_spec(mod)
        mod.loader.exec_module(ex)

        def solve(rows):
            res = solve_fleet(
                [ex.box_qp(cs.BOX_D, cs.SEED + int(i)) for i in rows],
                [np.zeros(cs.BOX_D, dt)] * len(rows), cfg)
            return jax.tree.map(lambda *a: jnp.stack(a), *res)
        return solve
    if base.startswith("mixed_"):
        name = base.removeprefix("mixed_")
        x0 = fp.port_x0(name, arr, dt)
        return (lambda rows: fp.solve_jax(
            name, {k: v[rows] for k, v in arr.items()}, x0[rows],
            dt.name))
    if base == "wide_portfolio":
        from pyipm_tpu.models import applications as japp
        from pyipm_tpu_torch.models import applications as app
        W = cs.WIDE_PORTFOLIO
        x0 = app.portfolio_x0(W["B"], W["D"], dt, device="cpu").numpy()
        fn = japp.make_portfolio_batch_solver(cfg, W["D"])
        return (lambda rows: fn(jnp.asarray(x0[rows]), japp.PortfolioData(
            *(jnp.asarray(arr[k][rows])
              for k in japp.PortfolioData._fields))))
    from pyipm_tpu.models.random_nlp import DenseNLPData, make_dense_nlp_solver
    from pyipm_tpu_torch.models.random_nlp import sample_dense_arrays
    if arr is None:
        arr = sample_dense_arrays(sp["seed"], sp["sizes"]["D"],
                                  sp["sizes"]["M"], sp["sizes"]["hidden"],
                                  dtype=dt)
    x0 = np.full(sp["sizes"]["D"], 0.0 if cell == "dense_lbfgs"
                 else cs.DENSE_X0, dt)
    fn = make_dense_nlp_solver(cfg, sp["sizes"]["D"], sp["sizes"]["M"])
    return (lambda rows: jax.tree.map(lambda a: a[None], fn(
        jnp.asarray(x0), DenseNLPData(
            *(jnp.asarray(arr[k]) for k in DenseNLPData._fields)))))


def _block_solver(cell):
    """``solve()``: the JAX package's result of the Schur cell ``cell``
    (its ``draw_block`` arrays, one device), and the arrays."""
    import jax
    import jax.numpy as jnp

    from pyipm_tpu import IPMConfig as JCfg
    from pyipm_tpu.models import applications as JA
    from pyipm_tpu.parallel import schur as JS

    c = cs.BLOCK_CELLS[cell]
    z = c["instance"]
    if c["config"]["float_dtype"] == "float64":
        jax.config.update("jax_enable_x64", True)
    cfg = JCfg(**c["config"])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    arrays = cs.draw_block(cell)
    tree = jax.tree.map(jnp.asarray, arrays)
    dt = jnp.dtype(c["config"]["float_dtype"])
    x0 = jnp.zeros((z["K"], z["d"]), dt)
    key = jax.random.key(0)
    # the JAX samplers' own specs: their closures depend on the sizes only
    if c["family"] == "separable":
        fn = JS.make_separable_solver(JS.sample_separable(
            key, 1, z["d"], z["mc"], jnp.float32)[0], mesh, cfg)
        return (lambda: fn(x0, JS.SeparableData(**tree))), arrays
    if c["family"] == "resource":
        spec = JA.make_resource_alloc_spec(z["d"], z["nres"], z["neq"],
                                           cap=z["cap"])
        x0 = x0 + 1
    elif c["family"] == "general":
        spec = JS.sample_block_general(
            key, 1, z["d"], z["me"], z["ni"], z["p"], z["mc"],
            dtype=jnp.float32, nonlinear_cc=z["nonlinear_cc"])[0]
    elif c["family"] == "ragged":
        spec = JS.sample_block_ragged(key, 1, z["d"], z["me"], z["ni"],
                                      z["p"], z["mc"], dtype=jnp.float32)[0]
    else:
        spec = JS.BlockNLP(
            f_blk=lambda xk, th: 0.5 * xk @ (th["q"] * xk) + th["c"] @ xk,
            d=z["d"], ci_blk=JS.box_ci("lb"), ni=z["d"], ci_identity=True,
            g_blk=lambda xk, th: th["A"] @ xk,
            cc=lambda u, ccd: u - ccd["b"], p=z["p"], mc=z["p"])
    fn = JS.make_block_solver(spec, mesh, cfg)
    return (lambda: fn(x0, tree["theta"], ccdata=tree["ccdata"])), arrays


def solve_block(cell):
    """The JAX package's answer to the Schur cell ``cell``: (dict of numpy
    fields, whether a Pallas kernel was reached in interpret mode, the
    input arrays' digests)."""
    import jax

    solve, arrays = _block_solver(cell)
    digests = cs.input_digests(arrays)
    del arrays
    seen = []
    if spec(cell)["jax_path"] == KERNEL:
        with fp.kernel_path() as seen:
            res = jax.block_until_ready(solve())
    else:
        res = jax.block_until_ready(solve())
    out = {k: np.asarray(getattr(res, k)) for k in (
        "signal", "iter_count", "fval", "x", "kkt", "lc")}
    out["lci"] = np.asarray(getattr(res, "lci", np.zeros(0, out["lc"].dtype)))
    return out, bool(seen), digests


def solve_rows(cell, rows=None):
    """The JAX package's result of ``rows`` of ``cell`` (all by default)
    along the cell's path: (dict of numpy fields, whether a Pallas kernel
    was reached in interpret mode)."""
    import jax

    solve = _solver(cell)
    rows = np.arange(spec(cell)["instances"]) if rows is None else \
        np.asarray(rows)
    seen = []
    if spec(cell)["jax_path"] == KERNEL:
        with fp.kernel_path() as seen:
            res = jax.block_until_ready(solve(rows))
    else:
        res = jax.block_until_ready(solve(rows))
    return ({k: np.asarray(getattr(res, k))
             for k in ("signal", "iter_count", "fval", "x", "kkt")},
            bool(seen))


def x_rows(cell):
    """The rows whose x a cell's file keeps."""
    n = spec(cell)["instances"]
    keep = X_ROWS_F64 if cell in cs.F64_CELLS else X_ROWS
    return np.unique(np.r_[np.arange(min(n, keep)), NAMED_ROWS.get(
        cell.removesuffix("_f64"), ())]).astype(np.int32)


def run_cell(cell):
    """Solve one cell, write its file and its manifest entry."""
    import jax
    import jaxlib

    sp = spec(cell)
    dt = sp["config"]["float_dtype"]
    t0 = time.perf_counter()
    extra = {}
    if cell in cs.BLOCK_CELLS:
        out, pallas, digests = solve_block(cell)
        wall = time.perf_counter() - t0
        nb, nc = cs.block_x_layout(*out["x"].shape)
        arrays = dict(signal=out["signal"].astype(np.int8),
                      iter_count=out["iter_count"].astype(np.int16),
                      f=out["fval"].astype(np.float64),
                      kkt=out["kkt"].astype(np.float64),
                      lc=out["lc"].astype(dt), lci=out["lci"].astype(dt),
                      x=out["x"][:nb, :nc].astype(dt))
        extra = dict(inputs=digests, x_blocks=nb, x_entries=nc)
    else:
        out, pallas = solve_rows(cell)
        wall = time.perf_counter() - t0
        xr = x_rows(cell)
        arrays = dict(signal=out["signal"].astype(np.int8),
                      iter_count=out["iter_count"].astype(np.int16),
                      f=out["fval"].astype(np.float64), x_rows=xr,
                      x=out["x"][xr].astype(dt))
        if sp["instances"] == 1:
            arrays["kkt"] = out["kkt"].astype(np.float64)
        extra = dict(x_rows=_runs(xr))
        if cell.removesuffix("_f64") in cs.F64_TWINS:
            extra["inputs"] = cs.input_digests(cs.twin_arrays(cell))
    blob = npz_bytes(arrays)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{cell}.npz"), "wb") as fh:
        fh.write(blob)
    sig, cnt = np.unique(arrays["signal"], return_counts=True)
    entry = dict(
        sp, file=f"{cell}.npz", dtype=dt, pallas_interpret_reached=pallas,
        **extra, jax_version=jax.__version__,
        jaxlib_version=jaxlib.__version__,
        numpy_version=np.__version__, wall_s=round(wall, 1),
        signals={str(int(k)): int(v) for k, v in zip(sig, cnt)},
        mean_iters=float(arrays["iter_count"].mean()),
        sha256=hashlib.sha256(blob).hexdigest(), bytes=len(blob))
    man = manifest()
    man["cells"][cell] = entry
    man["cells"] = {c: man["cells"][c] for c in CELLS if c in man["cells"]}
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as fh:
        json.dump(man, fh, indent=1)
        fh.write("\n")
    print(json.dumps({cell: {k: entry[k] for k in (
        "jax_path", "pallas_interpret_reached", "signals", "mean_iters",
        "wall_s", "bytes")}}), flush=True)


def npz_bytes(arrays):
    """``arrays`` as the bytes of a compressed .npz with fixed timestamps,
    so a cell solved again to the same bits writes the same file."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for k, v in arrays.items():
            info = zipfile.ZipInfo(f"{k}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            with zf.open(info, "w") as fh:
                np.lib.format.write_array(fh, np.asarray(v),
                                          allow_pickle=False)
    return buf.getvalue()


def manifest():
    try:
        with open(os.path.join(OUT, "MANIFEST.json")) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {"generated_by": "scripts/make_jax_reference.py",
                "held_by": "chip_smoke.hold_to_jax", "cells": {}}


def _runs(rows):
    """[[first, last], ...]: the runs of consecutive rows."""
    cuts = np.flatnonzero(np.diff(rows) != 1)
    return [[int(rows[a]), int(rows[b])] for a, b in
            zip(np.r_[0, cuts + 1], np.r_[cuts, rows.size - 1])]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", choices=CELLS,
                    help="a cell to (re)generate (repeatable; default all)")
    args = ap.parse_args()
    cells = args.cell or CELLS
    if len(cells) == 1:
        import jax
        jax.config.update("jax_platforms", "cpu")
        return run_cell(cells[0])
    t0 = time.perf_counter()
    for cell in cells:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--cell",
                        cell], check=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    print(f"{len(cells)} cells in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
