#!/usr/bin/env python3
"""The port's straddler assembly against the JAX package's one-by-one rule
at the d = 200 all <=3-way D&C workload, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/dnc_d200_parity.py \
        [--d 200] [--strategy auto]

The port plans ``all_kway(mixed_domain(d), 3)`` with
``select(strategy="auto")`` (``--strategy dnc`` below d = 200, where
"auto" stays monolithic), measures mixture marginals and reconstructs
its blocks with ``device="cpu"``.  From those block tables every straddler
(a workload marginal whose attributes fall in several blocks) is assembled
twice: by the port's ``CompositeEngine._assemble`` (one broadcast product
per group of straddlers with one shape) and by the JAX package's
``CompositeEngine._assemble`` (one ``np.multiply.outer`` chain per
straddler), run on the JAX package's own partition and decomposition of
the same workload.  The reference finds a straddler's parts with
``Decomposition.parts_of`` (a scan of every part per straddler, too slow
for 1.3 million straddlers); here it is given the same parts from one
stable argsort of the reference's ``part_row``, checked against
``parts_of`` itself on PARTS_SAMPLE straddlers.  The mixture marginals
and the noise are drawn from SEED.  Prints one JSON line: the
largest difference, the tables that differ, and the seconds of each
assembly.  Peaks near 7 GiB of host memory at d = 200.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

SEED = 0                # mixture marginals and noise
PARTS_SAMPLE = 500      # straddlers whose parts are checked by parts_of


def parts_index(jdec):
    """``parts_of`` of every straddling row from one stable argsort."""
    order = np.argsort(jdec.part_row, kind="stable")
    rows = jdec.part_row[order]
    cut = np.flatnonzero(np.diff(rows)) + 1
    index = {}
    for grp in np.split(order, cut):
        if grp.size:
            index[int(jdec.part_row[grp[0]])] = [
                (int(jdec.part_block[i]), jdec.part_clique(i)) for i in grp]
    return index


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--strategy", choices=("auto", "dnc"), default="auto")
    args = ap.parse_args()

    import torch
    from repro.core import Domain as JDomain
    from repro.core import MarginalWorkload as JWorkload
    from repro.core.partition import DEFAULT_MAX_BLOCK
    from repro.core.partition import decompose as j_decompose
    from repro.core.partition import partition_attributes as j_partition
    from repro.engine.composite import CompositeEngine as JCompositeEngine
    from repro_torch.core import CompositePlan, Domain, all_kway, select
    from repro_torch.data.tabular import mixture_marginals

    sizes = [(i % 9) + 2 for i in range(args.d)]
    secs = {}
    t0 = time.perf_counter()
    wk = all_kway(Domain.create(sizes), 3, include_lower=True)
    plan = select(wk, 1.0, strategy=args.strategy)
    secs["port select"] = time.perf_counter() - t0
    if not isinstance(plan, CompositePlan):
        raise SystemExit(f"d={args.d} stays monolithic under "
                         f"{args.strategy!r}")
    d = plan.decomposition
    t0 = time.perf_counter()
    jwk = JWorkload(JDomain.create(sizes), tuple(wk.cliques))
    jdec = j_decompose(jwk, j_partition(jwk, max_block=DEFAULT_MAX_BLOCK))
    secs["reference decompose"] = time.perf_counter() - t0
    same_dec = (
        [tuple(b) for b in jdec.partition.blocks]
        == [tuple(b) for b in plan.partition.blocks]
        and all(np.array_equal(getattr(jdec, f), getattr(d, f))
                for f in ("row_block", "row_pos", "part_row", "part_block",
                          "part_pos"))
        and all(jb.cliques == pb.cliques for jb, pb in
                zip(jdec.block_workloads, d.block_workloads)))
    if not same_dec:
        raise SystemExit("the two packages decompose the workload apart")

    t0 = time.perf_counter()
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(plan.cliques) + list(wk.cliques))), 1e6, SEED)
    eng = plan.engine(device="cpu")
    meas = eng.measure(exact, torch.Generator().manual_seed(SEED))
    del exact
    block_tables = eng._block_tables(meas)
    total = float(np.asarray(meas[()].omega, float).reshape(-1)[0])
    del meas
    secs["port measure and block reconstruct"] = time.perf_counter() - t0
    strad = [wk.cliques[r] for r in np.flatnonzero(d.row_block < 0)]

    t0 = time.perf_counter()
    index = parts_index(jdec)
    pick = np.linspace(0, len(index) - 1, min(PARTS_SAMPLE, len(index)))
    rows = sorted(index)
    checked = [rows[int(i)] for i in pick]
    parts_ok = all(jdec.parts_of(r) == index[r] for r in checked)
    secs["reference parts index"] = time.perf_counter() - t0
    if not parts_ok:
        raise SystemExit("the parts index differs from parts_of")
    jdec.parts_of = index.__getitem__
    ref_self = types.SimpleNamespace(
        plan=types.SimpleNamespace(decomposition=jdec))

    t0 = time.perf_counter()
    got = eng._assemble(block_tables, total, strad)
    secs["port assembly (grouping built)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = JCompositeEngine._assemble(ref_self, block_tables, total, strad)
    secs["reference assembly"] = time.perf_counter() - t0

    worst, differ, cells = 0.0, 0, 0
    for c in strad:
        a, b = got[c], want[c]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise SystemExit(f"table {c}: {a.shape} {a.dtype} against "
                             f"{b.shape} {b.dtype}")
        cells += a.size
        if not np.array_equal(a, b):
            differ += 1
            worst = max(worst, float(np.abs(a - b).max()))
    n_parts = np.bincount(d.part_row)[np.flatnonzero(d.row_block < 0)]
    print(json.dumps({
        "d": args.d, "blocks": plan.n_blocks, "straddlers": len(strad),
        "straddlers_by_parts": {int(k): int((n_parts == k).sum())
                                for k in np.unique(n_parts)},
        "straddler_cells": cells, "parts_of_checked": len(checked),
        "tables_that_differ": differ, "max_abs_diff": worst,
        "seconds": secs,
        "peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20}))
    if differ:
        raise SystemExit("the port's assembly differs from the reference's")


if __name__ == "__main__":
    main()
