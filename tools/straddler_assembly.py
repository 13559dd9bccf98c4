#!/usr/bin/env python3
"""Host time of the port's straddler assembly against the JAX package's
per-straddler loop, at the d = 500 all <=2-way D&C workload.

    PYTHONPATH=src python3 tools/straddler_assembly.py [--d 500] [--reps 3]

A straddler is a workload marginal whose attributes fall in several blocks
of a D&C plan; its table is the normalized outer product of its per-block
part tables.  ``CompositeEngine._assemble`` groups the straddlers by their
parts' shapes and forms each group in one broadcast product.  The loop here
is the JAX package's ``_assemble`` (one ``np.multiply.outer`` chain per
straddler), given its parts from one stable argsort of ``part_row`` instead
of the reference's scan of every part per straddler.  Both run on the same
block tables (the exact marginals of a seeded mixture; the assembly does
not look at where its tables came from), must agree bit for bit, and each
is timed ``--reps`` times: the engine's on its first call (which builds its
grouping) and on a later one.  The host runs it all; no card is used.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def loop_assemble(plan, block_tables, total):
    """The JAX package's per-straddler loop over a precomputed parts index."""
    d = plan.decomposition
    dom = d.workload.domain
    order = np.argsort(d.part_row, kind="stable")
    cut = np.flatnonzero(np.diff(d.part_row[order])) + 1
    out = {}
    for grp in np.split(order, cut):
        if not grp.size:
            continue
        tab, attrs = None, []
        for i in grp:
            pb, pc = int(d.part_block[i]), d.part_clique(i)
            pt = np.asarray(block_tables[pb][pc], float).reshape(
                dom.clique_sizes(pc))
            tab = pt if tab is None else np.multiply.outer(tab, pt)
            attrs.extend(pc)
        if len(grp) > 1:
            tab = tab / float(total) ** (len(grp) - 1)
        perm = np.argsort(np.asarray(attrs))
        out[d.workload.cliques[int(d.part_row[grp[0]])]] = \
            np.ascontiguousarray(np.transpose(tab, perm)).reshape(-1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from repro_torch.core import Domain, all_kway, select
    from repro_torch.data.tabular import mixture_marginals
    from repro_torch.engine.composite import CompositeEngine

    dom = Domain.create([(i % 9) + 2 for i in range(args.d)])
    wk = all_kway(dom, 2, include_lower=True)
    plan = select(wk, 1.0, strategy="dnc")
    d = plan.decomposition
    exact = mixture_marginals(dom, list(dict.fromkeys(
        list(plan.cliques) + list(wk.cliques))), 1e6, 0)
    block_tables = [{c: np.asarray(exact[c], np.float32)
                     for c in bw.cliques} for bw in d.block_workloads]
    total = float(exact[()][0]) if () in exact else 1e6
    strad = [wk.cliques[r] for r in np.flatnonzero(d.row_block < 0)]
    eng = CompositeEngine(plan, device="cpu")
    times = {"grouped first": [], "grouped": [], "loop": []}
    for _ in range(args.reps):
        for name in times:
            if name == "grouped first":     # the engine's first call also
                eng._straddlers = None      # builds its grouping, once
            t0 = time.perf_counter()
            if name == "loop":
                ref = loop_assemble(plan, block_tables, total)
            else:
                got = eng._assemble(block_tables, total, strad)
            times[name].append(time.perf_counter() - t0)
    same = all(np.array_equal(got[c], ref[c]) for c in strad)
    print(json.dumps({"d": args.d, "straddlers": len(strad),
                      "seconds": times,
                      "median_s": {k: statistics.median(v)
                                   for k, v in times.items()},
                      "bit_identical": same}))
    if not same:
        raise SystemExit("the two assemblies differ")


if __name__ == "__main__":
    main()
