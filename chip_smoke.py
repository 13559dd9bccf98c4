#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. Build both CUDA kernels from src/repro_torch/kernels/kron_matvec/csrc with
   nvcc (in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (rel 2e-5 of max|plain|), and time kernel, plain
   version and one torch.einsum call for the same function with CUDA events
   (followed by torch.cumsum on the marked axes for the chains with the
   ResidualPlanner+ 'cumsum' epilogue), and the narrow kernel (bf16 and
   fp16 operands, float32 sums) on Synth-10^100's 3-way reconstruct chain
   against its narrow plain version (rel 1e-2 / 2e-3 of max|plain|), its
   yardstick an einsum on operands of the same type; and HDMM's universe
   chains (one row of 10^8 cells through m = 1 ones rows on the per-axis
   kernel, one of 100 cells on the fused one).  Then apply R_A's and Q_A's
   Kronecker factors (residual_factors, marginal_factors) to 4 seeded
   float32 rows with the fused kernel, for every clique of the closure of
   all <=3-way cliques of sizes (3, 4, 5, 2) and (2, 7, 3), each against
   the dense float64 R_A and Q_A (expand_residual, expand_marginal) within
   rel 2e-5 (these launches are checks and are left out of the kernels
   line's count), and check a small release against the float64 host
   oracles.
3. Adult, all <=3-way marginals: select_sum_of_variances -> MarginalEngine
   (device="cuda") -> release, marginals from seeded synthetic records.
   Every table within 6 sigma of the exact marginal; both kernels launched;
   then one more release under the profiler, its device time by kernel.
4. Synth-10^d (d = 100), all <=3-way: the same release over marginals of a
   seeded mixture; every table within 7 sigma (about 1.6e8 cells: at 6 sigma
   some 0.3 cells would exceed the bound by chance, at 7 sigma 4e-4), and
   its device time by kernel as for Adult.
5. [rplus-synth] ResidualPlanner+ on Synth-10^20, every attribute a range
   query, all <=3-way, hierarchical strategy: select_plus (SoV) ->
   PlusEngine -> release; every range answer within 7 sigma (per-cell sigma
   from cell_variances_plus; about 1.9e8 cells) of the exact answer.
6. [rplus-adult] ResidualPlanner+ in the paper's section 9 prefix setting:
   Adult <=3-way, attributes 0-4 prefix queries with p-Identity strategies
   (strategy_mode="auto"), the rest identity, on the [adult] records; every
   answer within 6 sigma; both kernels and the in-kernel epilogue launched.
7. [autotune] the Synth-10^100 and Adult chain groups pretuned in measure
   mode (float32, bfloat16 and float16 offered): each pick against the cost
   model's first pick; then Synth's two 3-way chains' times per call (CUDA
   events over back-to-back calls) under REPRO_KERNEL_AUTOTUNE=off and
   =model, three alternated runs each (the median under model within 1.1x
   of the median under off), and the Adult release's device time under
   each mode.
8. [adult-bf16] the Adult <=3-way release with
   REPRO_KERNEL_COMPUTE_DTYPES=bfloat16: measure chains at float32,
   reconstruct chains on the fused kernel at bf16 (narrow launches > 0),
   every table within rel 3e-2 of its group's max |float32 table|.
9. [select-device] select_max_variance(backend="device") on the card:
   Adult <=3-way against the numpy loop (losses, float64 primal-dual gaps,
   seconds), and Synth-10^100 <=3-way (about 1.3M incidence entries) alone
   (seconds, iterations, gap; loss at most the SoV plan's max variance).
10. [select-convex] select_convex(loss="max_variance") on Adult <=3-way on
   the card and with device="cpu" (seconds, ratio to the max-variance
   optimum), and the l2 norm of the variance vector as a user callable.
11. [secure-adult] the secure discrete release (plan.engine(secure=True),
   digits=4) of the Adult <=3-way SoV plan on the [adult] records: every
   table within 6 sigma (sigma^2_A replaced by the engine's sigma-bar^2_A);
   tier counts; seconds split into draws, H, Y-dagger and reconstruct;
   device ms by kernel of one more measure + reconstruct with the draws
   replaced by zeros; both kernels launched, H and Y-dagger at float32
   only; every device-tier group's float32 H equal to the host int64 H bit
   for bit.
12. [secure-synth2] the same on Synth-10^100 all <=2-way (5,051 cliques) over
   the marginals of 4,000 seeded records: every group's H on the device
   tier (the 2-way bound is 4,000 * 400 * 10 < 2^24), 7 sigma per table,
   the same bit-for-bit H check.
13. [release-adult] the Adult <=3-way release with postprocess=
   "consistent" twice from one seed (bit-identical; 6 sigma; equal to the
   raw family within 5e-5 of max|raw|), the card's float32 CG against the
   host fp64 CG (5e-5 of max|r|), device ms of one CG solve by kernel,
   then "nonneg" (cells >= 0, every table's sum equal to the fitted total
   within 2 ulp, the card's projection twice bit-identical) and
   synthesize(48,842) (shape, dtype, ranges, synth_report).  Seconds by
   stage: measure, reconstruct, operator build, rhs (host), device set-up,
   CG (device; iterations, relative residual), marginals (host),
   projection, synthesis.
14. [release-adult-tree] the chain (0,1),...,(12,13) on Adult's domain:
   nonneg, synthesize(1,000,000); max_tv < 0.05 against the released
   tables, chi-square at z = 6 against the sampler's chain joint (the
   chi-square against the released tables is printed, see the phase).
15. [release-synth] Synth-10^100 <=3-way, "consistent" twice (bit-identical,
   7 sigma, equal to raw), device ms of one CG solve, peak device memory.
16. [release-secure] the [secure-synth2] engine with "nonneg": every table
   keeps the measured integer total.
17. [dnc-parity] divide and conquer on d = 40 (8 disjoint groups of 5
   attributes, all <=3-way inside each): compare_with_monolithic's ratio
   within 1e-9 of 1; CompositeEngine and MarginalEngine releases on the
   card, each within 6 sigma of every exact marginal.
18. [dnc-d500] d = 500 all <=2-way, strategy="dnc": seconds of select_dnc
   and variances_array, blocks, straddlers, peak host RSS; a release over
   mixture marginals (in-block and 1-way tables within 6 sigma,
   straddlers within 6 sigma of the product of their exact parts, their
   distance from the exact marginal printed in the proxy sigma), two
   releases from one seed bit-identical, device ms by kernel of the second
   one, nonneg (cells >= 0, sums equal to the pinned total) and
   synthesize(100,000).
19. [sharded-adult] sharded tables of the Adult records on the card, alone
   and under a one-rank NCCL group, equal to the host tables;
   sharded_measure equal to MarginalEngine.measure bit for bit (the second
   call a cache hit); corpus_marginal_release(postprocess="consistent")
   within 6 sigma; the secure sharded measure of [secure-synth2] equal to
   DiscreteEngine.measure bit for bit.
20. [obs] one Adult release traced to a JSONL file: engine spans with
   kernel.chain children, tables equal to the untraced ones, /metrics with
   the shared families and the roofline gauges; seconds traced and not.
21. [dnc-d200] d = 200 all <=3-way: select(strategy="auto") returns a
   CompositePlan (in a child process: seconds, peak host RSS; then in the
   phase's process, the same blocks and straddlers), released on the card with
   [dnc-d500]'s gates over 1,333,500 tables (2.79e8 cells; 1,306,015
   straddlers of 2 and 3 parts), the second release profiled as there.
   Seconds by stage, straddlers and cells by number of parts, peak host
   RSS and device memory.  tools/dnc_d200_parity.py (CPU, both packages)
   holds the straddler assembly to the JAX package's rule at this width.
22. [rplus-maxvar] RP+ max-variance on the card twice (sigma bit-identical)
   and on the CPU (loss within rel 5e-3).
23. [serve-adult] the release server (repro_torch.serve) at a service's
   size: 8 tenants with their own Adult <=3-way plans, rho and 48,842
   seeded records, 16 requests drained as one fused batch on both kernels;
   measurements and tables bit for bit against measure()/reconstruct and a
   max_batch=1 drain, 7 sigma over the 16 releases' 3.4e8 cells (the
   releases past 6 sigma counted), budget refusal, nonneg + synthesis, RP+ and
   secure tenants on the solo path, ledger replay, /healthz, /metrics ==
   /stats; wall seconds, requests/s, p50/p99 and device ms by kernel.
24. [serve-cli] python -m repro_torch.launch.serve --once in a child process.
25. [hdmm-synth] the paper's HDMM baseline (Tables 2-4) on Synth-10^d, all
   <=3-way, d = 2, 6, 8: hdmm_marginals (host seconds), then
   hdmm_measure_reconstruct's universe-sized chains on the kernels (the
   fused one at d = 2, the per-axis one beyond) over the universe vector
   of 48,842 seeded records; every answer within 6 sigma, the d = 8
   squared errors in a 5 sigma chi-square band, device ms by kernel and
   peak device memory; RP on the same records beside it (HDMM's RMSE >=
   RP's * 0.999, RP's equal to the SVD bound within 1e-9); d = 10 raises
   MemoryError and allocates nothing (Table 3's wall).
26. [hdmm-prefix] Tables 8-9: CPS, Adult and Loans <=3-way with prefix
   numeric attributes: RP+ (sov) and hdmm_generalized RMSE, HDMM's max
   variance, seconds; CPS (280,000 cells) released end to end by
   PlusEngine and by HDMM on the per-axis kernel, 6 sigma; Adult and
   Loans refused at HDMM's guard.
27. [lm-serve] the LM plane's serving path (repro_torch.models): Qwen3-4B
   and RecurrentGemma-2B at their published widths (seeded weights on the
   card, float32, bf16 compute), 4 requests of 32 prompt tokens and 16
   greedy tokens through examples/serve_lm_torch.py: init and prefill
   seconds, decode tokens/s, peak device memory, the first request's
   tokens; each decode step against the teacher-forced prefill at float32
   (rel 1e-4) and bf16 (rel 3e-2, or the bf16 prefill's own distance from
   float32 where larger) compute; two Qwen3-4B runs from one seed
   give the same tokens; all ten architectures at reduced_config on the
   card against the CPU (rel 1e-4). No kernel of the port runs here: the
   reference's LM plane reaches no pl.pallas_call.
28. [lm-train] the LM plane's training path (repro_torch.train): Qwen3-4B
   at its published widths and full depth, 6 steps (2 microbatches, remat
   "dots") on one 8 x 128 batch: step seconds, tokens/s, peak device
   memory, losses and grad norms, device ms and launches of one step;
   gates: finite, the sixth loss below the first, the first within rel
   1e-5 of the eval loss, which a lost microbatch would exceed (the first
   microbatch's eval loss alone is held off the bound).  xLSTM-350M at full width, 3 DP-SGD steps:
   the vmap clipped mean against a per-example loop (rel 1e-4, float32,
   the first 2 layers; at 24 the float32 rounding exceeds that, and
   tools/lm_dp_vmap_gap.py --float64 holds vmap to the loop there),
   the noise's mean and std within 5 standard errors.  All ten reduced
   architectures, one step on the card against the CPU (rel 1e-4);
   train_loop resumed bit for bit; examples/dp_corpus_stats_torch.py with
   exactly 3 funded steps and fused launches > 0.
29. [lm-mesh] the LM plane's multi-device serving path
   (repro_torch.models.sharding, repro_torch.launch.mesh): DeepSeek-V2-236B
   at published width, 4 of 60 layers (seeded bf16 weights), 2 prompts of
   512 tokens and 8 decode steps; the no-mesh model on card 0 at float32
   first, then one NCCL rank per visible card up to four ((1, 4) and
   (2, 2) on four cards, (1, 1) through a one-rank group on one): at
   float32 and capacity factor 8 the mesh's logits within rel 1e-4 of the
   no-mesh run's with 0 dropped pairs and the expert-parallel bodies
   counted (model axis > 1); at bf16 and capacity factor 1.25 prefill
   seconds, decode tokens/s, peak memory per rank, dropped pairs, NCCL
   device ms of a decode step, the next step's collective bytes (OpStats)
   and all_to_all bytes.  On more than one card
   Qwen3-4B at published width (4 of 36 layers) runs the same parity gate
   on each mesh in both attention modes (DeepSeek-V2's MLA reads none).
   Then reduced Whisper-small through its encoder's and cross attention's
   split regions on the same ranks, under the default rules and with the
   vocabulary replicated: prefill and 8 decode steps at float32 within
   rel 1e-4 of the no-mesh run on card 0.
   No kernel of the port runs here either.
30. [lm-mesh-train] the LM plane's training on a mesh (Model.loss_fn,
   make_train_step, AdamW and int8 moments on DTensors, sharded
   checkpoints) at (1, 1) through a one-rank NCCL group: Qwen3-4B at
   published width (4 of 36 layers, float32 compute, TF32 off), two steps
   with remat "dots" and off against two no-mesh steps on the card (each
   loss within rel 1e-5, every parameter and moment leaf within rel 1e-4
   of its max); DeepSeek-V2-236B at published width, 1 of 60 layers (the
   depth one card trains with a fifth free), bf16 with int8 moments: two
   steps (seconds, peak memory, finite losses) and a sharded save and
   restore, bit-equal. tools/lm_mesh.py --train runs the four-card runs.
   No kernel of the port runs here.
31. [lm-mesh-dp] DP-SGD on a mesh (repro_torch.train.dp) on min(cards, 4)
   NCCL ranks ((1, 1) on one card; (1, 4) and (2, 2) on four): one DP-SGD
   step of Qwen3-4B at published width (4 of 36 layers, float32, TF32 off)
   against the one-card DP step from the same generator state (loss and
   every parameter and moment leaf within rel 1e-5), reduced DeepSeek-V2's
   clipped mean against the one card's (capacity factor 100) and, where
   the model axis is larger than 1, with capacity drops against each
   example mesh clipping the batch alone; Qwen3-4B float32 trained by
   train_loop(dp=DPSGDConfig(), mesh=(1, N)) at full depth on four cards
   (8 layers on one): step seconds, peak GiB per rank, the accountant's
   report; the fake step's FLOPs and collective counts equal the real
   step's.  No kernel of the port runs here.
32. [dryrun] the dry run on fake tensors over a fake 256-rank process
   group (repro_torch.launch.dryrun) for qwen3-4b train_4k,
   deepseek-v2-236b decode_32k and recurrentgemma-2b prefill_32k (its
   RG-LRU loop counted from a few steps, exactly), in child processes on
   the host CPU started with the smoke: each status ok and counted warm
   (after an uncounted one-group step), their analyze rows
   (the H100 SXM datasheet row; counts, not measured times), the seconds
   the wait for each cell adds.
33. Print the kernels line (the fused kernel at float32, bf16 and fp16, and
   the per-axis kernel; launches over every phase above) and, last,
   {"ok": true, "device": {...}}.

[secure-adult] (11) and [dnc-d200] (21) are host-bound and hold under a GiB
of the card, so each runs in a child process of its own (python3
chip_smoke.py --phase NAME ...), started after [adult-bf16], the last phase
that gates on a time, beside phases 9-26; their output and launch counts are
read before [lm-serve], and a failed child fails the smoke.

[select-device] and [select-convex] also run each route twice more, on the
card and on the CPU, and require sigma and the loss bit-identical.

Phase 2 also pushes the exactness edge of the secure path's H chain through
both kernels: an H chain on (10, 10) whose one nonzero cell holds
floor((2^24 - 1) / 4000) must equal the int64 H on the fused kernel and on a
forced per-axis route, and one count more must send a DiscreteEngine to its
int64 tier.

The main path runs the autotuner in its default mode (model) from an empty
cache under build/; the tuner's picks go to build/autotune_picks.json.

It imports torch, numpy and the port only.  Without CUDA it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

REL_TOL = 2e-5        # of max|plain|: fmaf vs separate mul/add rounding
# of max|narrow plain|: the same rounding points, JAX-parity bounds
NARROW_TOL = {"bfloat16": 1e-2, "float16": 2e-3}
NARROW_NAME = {"bfloat16": "fused_chain_bf16", "float16": "fused_chain_fp16"}
BF16_RELEASE_TOL = 3e-2   # of a group's max |fp32 table|
SYNTH_D = 100
ADULT_RECORDS = 48842  # rows of the Adult data set
SYNTH2_RECORDS = 4000  # [secure-synth2]: every 2-way H bound below 2^24
F32_EXACT = 1 << 24    # integers below this are exact in float32
SEED = 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now, as
    nvidia-smi reads them (sampled right after a timed run)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                          "power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    return out.strip().splitlines()[0] if out.strip() else "not read"


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls, after one warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PORT_KERNELS = ("fused_chain_kernel", "kron_axis_kernel")


def profiled(run, tries: int = 5):
    """(key_averages, complete) of a torch.profiler session over ``run()``.

    The profiler can drop kernel events (seen: 7 of 10 launches recorded in
    a session after busy ones), which makes a sum of device time too small.
    So the session is taken again, up to ``tries`` times, until it holds as
    many events of the port's kernels as the wrappers counted launches in
    it; ``complete`` says whether it got there."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.kron_matvec.stats import chain_stats

    def launched():
        st = chain_stats()
        return st["fused_launches"] + st["axis_launches"]

    for _ in range(tries):
        before = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        seen = sum(ev.count for ev in evs
                   if any(k in ev.key for k in PORT_KERNELS))
        if seen == launched() - before:
            return evs, True
    print(f"[profiler] {seen} of {launched() - before} kernel launches "
          f"recorded after {tries} tries; device times below undercount")
    return evs, False


def device_ms(fn, reps: int):
    """(kernel ms, copy ms) of one call of ``fn`` on the card, from
    torch.profiler's device events over ``reps`` calls (a session that
    recorded every launch of the port's kernels, see ``profiled``): the
    time the card spent in kernels and in memory copies, whatever the host
    spent around them.  (None, None) if the profiler recorded no device
    time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    evs, _ = profiled(run)
    kern = copy = 0.0
    for ev in evs:
        us = ev.self_device_time_total
        if ev.key.startswith(("Memcpy", "Memset")):
            copy += us
        else:
            kern += us
    if kern + copy <= 0:
        return None, None
    return kern / 1e3 / reps, copy / 1e3 / reps


def kernel_label(key: str) -> str:
    """The kernels line's name of a profiler kernel key: fused_chain (float
    operands), fused_chain_bf16, fused_chain_fp16, kron_axis; 'other' for
    every other kernel on the card (the noise draw, casts, cumsum)."""
    if "kron_axis_kernel" in key:
        return "kron_axis"
    if "fused_chain_kernel" in key:
        return ("fused_chain_bf16" if "bfloat16" in key else
                "fused_chain_fp16" if "__half" in key else "fused_chain")
    return "other"


def kernel_ms_by_name(fn):
    """Device ms of one call of ``fn`` in each kernel of the port (by
    kernel_label), from torch.profiler's device events (``profiled``);
    copies apart."""
    torch.cuda.synchronize()
    return kernel_ms(profiled(fn)[0])


def kernel_ms(evs):
    """Device ms of a profiler session's events in each kernel of the port
    (by kernel_label); copies apart."""
    out = {}
    for ev in evs:
        if ev.key.startswith(("Memcpy", "Memset")):
            continue
        name = kernel_label(ev.key)
        out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3
    return out


def card_spec():
    """The cost model's row of this card: the memory and fp32 rates every
    bound below uses (repro_torch/roofline/cost_model.py)."""
    from repro_torch.roofline import detect_device
    return detect_device("cuda")


def chain_work(factors, dims, batch, epilogue=(), factor_itemsize=4):
    """(bytes, FLOP) of one fused launch, counted as the cost model counts
    them: each float32 row read once and written once, the factors read
    once at their operand size; 2·m·n FLOP per output of every live axis
    and one add per output of every 'cumsum' axis."""
    from repro_torch.roofline import chain_bytes, chain_flops
    fshapes = [None if s is None else s.shape for s in factors]
    return (chain_bytes(dims, fshapes, batch, factor_itemsize),
            batch * chain_flops(dims, fshapes, epilogue))


def bound(nbytes, flops):
    """(least ms, what bounds it) at the card's memory and fp32 rates (the
    narrow kernel accumulates with fp32 FMAs too)."""
    spec = card_spec()
    t_mem = nbytes / spec.hbm_bw * 1e3
    t_ops = flops / spec.peak_flops_f32 * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def einsum_chain(factors, x, dims):
    """One torch.einsum call for the chain (timed as a yardstick only).
    x comes first so a left-to-right contraction is the per-axis chain;
    a None factor leaves its axis as it is."""
    letters = "ijklmnopqr"[:len(dims)]
    outs = "".join(i if f is None else o
                   for f, i, o in zip(factors, letters, "abcdefghst"))
    live = [(f, o, i) for f, o, i in zip(factors, outs, letters) if f is not None]
    spec = (f"z{letters}," + ",".join(f"{o}{i}" for _, o, i in live)
            + f"->z{outs}")
    return torch.einsum(spec, x.view(x.shape[0], *dims),
                        *[f for f, _, _ in live]).reshape(x.shape[0], -1)


def einsum_cumsum_chain(factors, x, dims, epilogue):
    """The library yardstick of an epilogue chain: einsum_chain, then one
    torch.cumsum per marked axis."""
    y = einsum_chain(factors, x, dims)
    out = [n if f is None else f.shape[0] for f, n in zip(factors, dims)]
    y = y.view(x.shape[0], *out)
    for axis, op in enumerate(epilogue):
        if op is not None:
            y = torch.cumsum(y, dim=axis + 1)
    return y.reshape(x.shape[0], -1)


def phase_build():
    from repro_torch.kernels._build import build
    t0 = time.perf_counter()
    reports = build(["fused_chain", "kron_axis"], force=True)
    print(f"[build] both kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def t_factor(kind, n):
    """T = [Sub^+ | 1/n] of an RP+ basis with the hierarchical strategy."""
    from repro_torch.core.plus import attr_basis, build_w, s_hierarchical
    b = attr_basis(build_w(kind, n), s_hierarchical(n))
    return np.hstack([b.sub_pinv, np.full((n, 1), 1.0 / n)])


def phase_kernels(card):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core.reconstruct import u_chain_factors
    from repro_torch.core.residual import sub_matrix
    from repro_torch.data.tabular import synth_domain
    from repro_torch.kernels.kron_matvec.fused import (
        fused_chain_matvec, fused_chain_matvec_plain, plan_chain)
    from repro_torch.kernels.kron_matvec.ops import kron_matvec_kernel
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_cliques = math.comb(SYNTH_D, 3)
    synth3 = synth_domain(10, 3)
    cumsum3 = ("cumsum",) * 3
    # (kernel, label, factors, dims, batch, epilogue, route): route "fused"
    # must fit the fused kernel, "axis" must not (the per-axis kernel, then
    # torch.cumsum for an epilogue).  The narrow cases pass their operand
    # type explicitly (the tuner serves it only to reconstruction chains
    # when REPRO_KERNEL_COMPUTE_DTYPES offers it, as in [adult-bf16]).
    recon3 = u_chain_factors(synth3, (0, 1, 2))
    narrow = [(NARROW_NAME[cd], "Synth-10^%d 3-way reconstruct chain at %s%s"
               % (SYNTH_D, cd, ", cumsum on 3 axes" if epi else ""),
               recon3, (10, 10, 10), n_cliques, epi, "fused")
              for cd in ("bfloat16", "float16") for epi in ((), cumsum3)]
    cases = [
        ("fused_chain", "Synth-10^%d 3-way measure chain" % SYNTH_D,
         [sub_matrix(10)] * 3, (10, 10, 10), 2 * n_cliques, (), "fused"),
        ("fused_chain", "Synth-10^%d 3-way reconstruct chain" % SYNTH_D,
         u_chain_factors(synth3, (0, 1, 2)), (10, 10, 10), n_cliques, (),
         "fused"),
        ("fused_chain", "(a) Synth-10^20 range 3-way reconstruct chain, "
         "cumsum on 3 axes", [t_factor("range", 10)] * 3, (10, 10, 10),
         math.comb(20, 3), cumsum3, "fused"),
        ("fused_chain", "(b) mixed (identity 9, prefix 85) chain, cumsum on "
         "both axes, 255 rows", [None, t_factor("prefix", 85)], (9, 85), 255,
         ("cumsum", "cumsum"), "fused"),
        ("fused_chain", "(c) Adult prefix (100,100,100) reconstruct chain, "
         "per-axis kernel + torch.cumsum", [t_factor("prefix", 100)] * 3,
         (100, 100, 100), 1, cumsum3, "axis"),
        ("kron_axis", "Adult (100,100,100) measure chain, 3 launches",
         [sub_matrix(100)] * 3, (100, 100, 100), 2, (), "axis"),
        # HDMM's universe-sized chains ([hdmm-synth]): one row of 10^8
        # cells through five m = 1 ones rows, and a universe of 100 cells
        # that fits a block.
        ("kron_axis", "HDMM Synth-10^8 3-way measure chain, 1 row of 10^8, "
         "ones rows on 5 axes, 5 launches", [np.ones((1, 10))] * 5
         + [None] * 3, (10,) * 8, 1, (), "axis"),
        ("fused_chain", "HDMM Synth-10^2 1-way measure chain, 1 row of 100",
         [np.ones((1, 10)), None], (10, 10), 1, (), "fused"),
    ] + narrow
    rows = []
    for name, label, facs, dims, batch, epi, route in cases:
        cd = next((k for k, v in NARROW_NAME.items() if v == name), None)
        s_facs = [None if s is None else np.asarray(s, np.float32) for s in facs]
        s_dev = [None if s is None else torch.as_tensor(s, device=dev)
                 for s in s_facs]
        x = torch.randn((batch, math.prod(dims)), generator=gen, device=dev)
        if plan_chain(s_facs, dims, batch=batch, compute_dtype=cd or "float32"
                      ).fused_ok != (route == "fused"):
            raise AssertionError(f"{label} does not take the {route} route")
        if cd is not None:
            kernel = lambda: fused_chain_matvec(  # noqa: E731
                s_facs, x, dims, epilogue=epi or None, compute_dtype=cd)
            bound_ms, bound_by = bound(*chain_work(s_facs, dims, batch, epi, 2))
        elif name == "fused_chain":
            kernel = lambda: fused_chain_matvec(  # noqa: E731
                s_facs, x, dims, epilogue=epi or None)
            bound_ms, bound_by = bound(*chain_work(s_facs, dims, batch, epi))
        else:
            kernel = lambda: kron_matvec_kernel(  # noqa: E731
                [None] + s_facs, x.reshape(-1), (batch,) + dims).reshape(batch, -1)
            # Each launch is one call of the per-axis function: its input,
            # factor and output cross memory once.
            bound_ms, t_mem, t_ops = 0.0, 0.0, 0.0
            cur = [batch] + list(dims)
            for axis, s in enumerate(s_facs, start=1):
                if s is None:
                    continue
                m, n = s.shape
                L, R = math.prod(cur[:axis]), math.prod(cur[axis + 1:])
                nbytes = 4 * (L * n * R + m * n + L * m * R)
                flops = 2 * L * m * n * R
                bound_ms += bound(nbytes, flops)[0]
                t_mem += nbytes / card_spec().hbm_bw * 1e3
                t_ops += flops / card_spec().peak_flops_f32 * 1e3
                cur[axis] = m
            bound_by = "operations" if t_ops >= t_mem else "bytes"
        plain = lambda: fused_chain_matvec_plain(  # noqa: E731
            s_facs, x, dims, epi, cd or "float32")
        if cd is not None:   # the yardstick on operands of the same type
            tdt = getattr(torch, cd)
            s_dev = [None if s is None else s.to(tdt) for s in s_dev]
            x_lib = x.to(tdt)
        else:
            x_lib = x
        if epi:
            library = lambda: einsum_cumsum_chain(  # noqa: E731
                s_dev, x_lib, dims, epi)
        else:
            library = lambda: einsum_chain(s_dev, x_lib, dims)  # noqa: E731
        reset_chain_stats()
        got = kernel()
        torch.cuda.synchronize()
        st = chain_stats()
        if cd is not None and not (st["fused_launches"] == 1
                                   and st["narrow_launches"] == 1):
            raise AssertionError(f"{label}: not one narrow fused launch: {st}")
        if epi and route == "fused" and not (st["fused_launches"] == 1
                                             and st["epilogue_launches"] == 1):
            raise AssertionError(f"{label}: the epilogue was not in the "
                                 f"fused launch: {st}")
        if label.startswith("HDMM") and not (
                st["fused_launches" if route == "fused" else "axis_launches"]
                and not st["axis_launches" if route == "fused"
                           else "fused_launches"]):
            raise AssertionError(f"{label}: not the {route} route: {st}")
        if epi and route == "axis" and not (st["fused_launches"] == 0
                                            and st["fallback_chains"] == 1
                                            and st["axis_launches"] == 3):
            raise AssertionError(f"{label}: not the per-axis route: {st}")
        want, lib = plain(), library()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got - want).abs().max())
        lib_err = rel_err(lib.float(), want)
        tol = REL_TOL if cd is None else NARROW_TOL[cd]
        reps = 20 if batch > 1000 else 50
        ms, plain_ms, lib_ms = (time_ms(kernel, reps), time_ms(plain, reps),
                                time_ms(library, reps))
        dev_ms, copy_ms = device_ms(kernel, reps)
        clk = clocks()
        lib_name = "einsum+cumsum" if epi else "einsum"
        dev_txt = ("not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms in kernels + {copy_ms:.4f} ms in copies")
        print(f"[kernels] {name} | {label}: rel err {err:.3e} (bound {tol}, "
              f"bit-identical {bool(torch.equal(got, want))}; {lib_name} "
              f"{lib_err:.3e}), kernel {ms:.4f} ms (device: {dev_txt}), plain "
              f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); clocks {clk} | {card}")
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label}: rel err {err:.3e}")
        rows.append(dict(name=name, case=label, max_abs_err=abs_err,
                         rel_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, device_kernel_ms=dev_ms,
                         device_copy_ms=copy_ms, epilogue=list(epi),
                         path=route, compute_dtype=cd or "float32"))
        del x, x_lib, got, want, lib
        torch.cuda.empty_cache()
    residual_dense_check(card)
    return rows


def residual_dense_check(card):
    """The fused kernel on the factor forms of R_A and Q_A against the
    dense float64 matrices, for every clique of the closure of all <=3-way
    cliques of two small domains: one launch for each chain with a live
    factor, none on the per-axis route."""
    from repro_torch.core import (Domain, all_kway, closure, expand_marginal,
                                  expand_residual, marginal_factors,
                                  residual_factors)
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    reset_chain_stats()
    worst, n_cliques, live = 0.0, 0, 0
    for sizes in ((3, 4, 5, 2), (2, 7, 3)):
        dom = Domain.create(list(sizes))
        x = rng.standard_normal((4, dom.universe_size())).astype(np.float32)
        x_dev = torch.as_tensor(x, device="cuda")
        for c in closure(all_kway(dom, 3, include_lower=True).cliques):
            for facs, dense in ((residual_factors(dom, c),
                                 expand_residual(dom, c)),
                                (marginal_factors(dom, c),
                                 expand_marginal(dom, c))):
                got = fused_chain_matvec(facs, x_dev, dom.sizes)
                got = got.double().cpu().numpy()
                want = x.astype(np.float64) @ dense.T
                err = float(np.abs(got - want).max()
                            / max(np.abs(want).max(), 1e-30))
                if not (got.shape == want.shape and np.isfinite(got).all()
                        and err <= REL_TOL):
                    raise AssertionError(
                        f"fused chain on {sizes} clique {c} disagrees with "
                        f"the dense float64 matrix: rel err {err:.3e}")
                worst = max(worst, err)
                live += any(f is not None for f in facs)
            n_cliques += 1
    torch.cuda.synchronize()
    st = chain_stats()
    secs = time.perf_counter() - t0
    print(f"[kernels] residual dense check | sizes (3,4,5,2) and (2,7,3), "
          f"{n_cliques} cliques of the <=3-way closures, R_A and Q_A on 4 "
          f"float32 rows: worst rel err {worst:.3e} (bound {REL_TOL}) against "
          f"expand_residual / expand_marginal in float64; fused launches "
          f"{st['fused_launches']} (not in the kernels line's count), "
          f"per-axis launches {st['axis_launches']}; {secs:.3f} s | {card}")
    if not (st["fused_launches"] == live and st["axis_launches"] == 0
            and st["fallback_chains"] == 0):
        raise AssertionError(f"residual dense check: {live} chains with a "
                             f"live factor, launches {st}")


def phase_small_reference():
    """A small release on the card against the float64 host oracles, fed
    the same noise the card drew."""
    from repro_torch.core import (Domain, all_kway, draw_noise,
                                  exact_marginals_from_x, measure, measure_np,
                                  reconstruct_all, select_sum_of_variances)
    from repro_torch.engine import MarginalEngine

    dom = Domain.create([3, 5, 2, 7])
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(SEED).integers(0, 9, dom.universe_size())
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    eng = MarginalEngine(plan, device="cuda")
    tables, meas = eng.release(margs, torch.Generator("cuda").manual_seed(7))
    loop = measure(plan, margs, torch.Generator("cuda").manual_seed(7),
                   batched=False, device="cuda")
    z = draw_noise(plan, torch.Generator("cuda").manual_seed(7), "cuda")

    class Replay:
        pos = 0
        flat = z.double().cpu().numpy()

        def standard_normal(self, n):
            out = self.flat[self.pos:self.pos + n]
            self.pos += n
            return out

    ref = measure_np(plan, margs, Replay())
    ref_tables = reconstruct_all(plan, ref)
    worst_m = worst_t = 0.0
    for c in plan.cliques:
        if not np.array_equal(meas[c].omega, loop[c].omega):
            raise AssertionError(f"batched and loop measurements differ on {c}")
        scale = max(np.abs(ref[c].omega).max(), 1.0)
        worst_m = max(worst_m, np.abs(meas[c].omega - ref[c].omega).max() / scale)
    for c in plan.workload.cliques:
        scale = max(np.abs(ref_tables[c]).max(), 1.0)
        worst_t = max(worst_t, np.abs(tables[c] - ref_tables[c]).max() / scale)
    print(f"[reference] sizes (3,5,2,7) <=3-way: batched == loop bit for bit; "
          f"measure rel err {worst_m:.2e}, reconstruct rel err {worst_t:.2e} "
          f"vs the float64 oracles")
    if not (worst_m < 1e-5 and worst_t < 1e-5):
        raise AssertionError("small release disagrees with the float64 oracles")


def check_tables(plan, tables, exact, k_sigma):
    """Every workload table finite, of its shape, within k_sigma of exact."""
    sd = np.sqrt(plan.variances_array())
    worst = 0.0
    for c, s in zip(plan.workload.cliques, sd):
        t = tables[c]
        if t.shape != (plan.domain.n_cells(c),) or not np.all(np.isfinite(t)):
            raise AssertionError(f"table {c} has shape {t.shape} or non-finite values")
        worst = max(worst, float(np.abs(t - exact[c]).max() / s))
    if not worst <= k_sigma:
        raise AssertionError(f"a table is {worst:.2f} sigma from its exact "
                             f"marginal (bound {k_sigma})")
    return worst


def check_plus_tables(plan, tables, exact, k_sigma, chunk=64):
    """Every RP+ answer finite, of its shape, within k_sigma of the exact
    answer (⊗ W_i of the exact marginal, float64), per-cell sigma as in
    cell_variances_plus.  Signature group by group and ``chunk`` cliques at
    a time, so host memory stays bounded."""
    from repro_torch.core.domain import subsets
    from repro_torch.core.plus import plus_signature_groups
    bases = plan.schema.bases
    worst = 0.0
    for group in plus_signature_groups(plan.schema,
                                       plan.workload.cliques).values():
        k = len(group[0])
        pos = tuple(range(k))
        axes = [bases[i] for i in group[0]]
        # diag(Ψ Ψᵀ) per axis, measured (W Sub⁺ Γ) and marginalized (W 1/n)
        meas = [((b.W @ b.sub_pinv @ b.Gamma) ** 2).sum(axis=1) for b in axes]
        marg = [(b.W @ np.ones(b.n) / b.n) ** 2 for b in axes]
        diags = []
        for sub in subsets(pos):
            d = np.ones(1)
            for a in pos:
                d = np.kron(d, meas[a] if a in sub else marg[a])
            diags.append(d)
        diags = np.stack(diags)                      # (2^k, query rows)
        for c0 in range(0, len(group), chunk):
            cs = group[c0:c0 + chunk]
            sig2 = np.array([[plan.sigma2(tuple(c[j] for j in sub))
                              for sub in subsets(pos)] for c in cs])
            sd = np.sqrt(sig2 @ diags)
            t = np.stack([exact[c] for c in cs]).reshape(
                (len(cs),) + tuple(b.n for b in axes))
            for a, b in enumerate(axes, start=1):
                t = np.moveaxis(np.tensordot(t, b.W, axes=([a], [1])), -1, a)
            got = np.stack([tables[c] for c in cs])
            if got.shape != sd.shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"tables of {cs[0]}.. have shape "
                                     f"{got.shape} or non-finite values")
            worst = max(worst, float(np.max(np.abs(got - t.reshape(got.shape))
                                            / sd)))
    if not worst <= k_sigma:
        raise AssertionError(f"an answer is {worst:.2f} sigma from its exact "
                             f"value (bound {k_sigma})")
    return worst


def release_phase(name, plan, make_marginals, k_sigma, plus=False,
                  by_kernel=False):
    """One release on the card with the kernel counts reset just before it
    and read just after; ``plus`` serves an RP+ plan with PlusEngine.
    ``by_kernel``: then one more release of the same engine under the
    profiler, its device time split by kernel."""
    from repro_torch.engine import MarginalEngine
    from repro_torch.engine.plus_engine import PlusEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    t0 = time.perf_counter()
    margs = make_marginals()
    secs = {"marginals": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    reset_chain_stats()
    t0 = time.perf_counter()
    eng = (PlusEngine if plus else MarginalEngine)(plan, device="cuda")
    secs["engine"] = time.perf_counter() - t0
    for step in ("measure", "reconstruct"):
        def timed(*a, _fn=getattr(eng, step), _step=step, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            secs[_step] = time.perf_counter() - t
            return out
        setattr(eng, step, timed)
    tables, _meas = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    counts = chain_stats()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    worst = (check_plus_tables if plus else check_tables)(plan, tables, margs,
                                                          k_sigma)
    secs["check"] = time.perf_counter() - t0
    cells = sum(plan.schema.query_rows(c) if plus else plan.domain.n_cells(c)
                for c in plan.workload.cliques)
    print(f"[{name}] closure {len(plan.cliques)} cliques, workload "
          f"{len(plan.workload.cliques)} marginals / {cells} cells, "
          f"{eng.stats.measure_signatures} measure + "
          f"{eng.stats.reconstruct_signatures} reconstruct signature groups, "
          f"fused chains {eng.stats.fused_chains}, per-axis chains "
          f"{eng.stats.fallback_chains}")
    print(f"[{name}] seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; peak device memory {peak / 2**30:.2f} GiB")
    print(f"[{name}] worst table {worst:.3f} sigma (bound {k_sigma}); "
          f"launches {counts}")
    if by_kernel:
        ms = kernel_ms_by_name(lambda: eng.release(
            margs, torch.Generator("cuda").manual_seed(SEED)))
        print(f"[{name}] device ms of one more release by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items())))
    return counts


def phase_rplus_synth():
    """[rplus-synth]: Synth-10^20, every attribute a range query, all
    <=3-way, hierarchical strategy; 7 sigma over about 1.9e8 answers."""
    from repro_torch.configs.synth_ranges import make
    from repro_torch.core.plus import select_plus
    from repro_torch.data.tabular import mixture_marginals
    t0 = time.perf_counter()
    dom, wk, schema = make(n=10, d=20, kmax=3, kind="range",
                           strategy_mode="hier", device="cuda")
    t1 = time.perf_counter()
    plan = select_plus(wk, schema, 1.0, "sov", device="cuda")
    print(f"[rplus-synth] schema {t1 - t0:.3f} s, select "
          f"{time.perf_counter() - t1:.3f} s")
    counts = release_phase("rplus-synth", plan, lambda: mixture_marginals(
        dom, plan.cliques, 1e6, SEED), 7.0, plus=True)
    if not (counts["fused_launches"] > 0 and counts["epilogue_launches"] > 0):
        raise AssertionError(f"RP+ Synth release skipped the fused kernel or "
                             f"its epilogue: {counts}")
    return counts


def phase_rplus_adult(adult):
    """[rplus-adult]: the paper's section 9 prefix setting on Adult <=3-way
    (attributes 0-4 prefix, p-Identity strategies), the [adult] records."""
    from repro_torch.core import all_kway
    from repro_torch.core.plus import PlusSchema, select_plus
    from repro_torch.data.tabular import (marginals_from_records,
                                          synthetic_records)
    kinds = ["prefix" if i < 5 else "identity" for i in range(adult.n_attrs)]
    t0 = time.perf_counter()
    schema = PlusSchema.create(adult, kinds, strategy_mode="auto",
                               device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan = select_plus(all_kway(adult, 3, include_lower=True), schema, 1.0,
                       "sov", device="cuda")
    print(f"[rplus-adult] schema (opt_pidentity, 1000 Adam steps for each of "
          f"3 distinct W) {t1 - t0:.3f} s, select "
          f"{time.perf_counter() - t1:.3f} s")
    counts = release_phase("rplus-adult", plan, lambda: marginals_from_records(
        adult, plan.cliques, synthetic_records(adult, ADULT_RECORDS, SEED)),
        6.0, plus=True)
    if not (counts["fused_launches"] > 0 and counts["axis_launches"] > 0
            and counts["epilogue_launches"] > 0):
        raise AssertionError(f"RP+ Adult release skipped a kernel or the "
                             f"epilogue: {counts}")
    return counts


def engine_chains(plan):
    """(factors, dims, batch, epilogue, role) of every chain MarginalEngine
    registers for ``plan``: the tuner's chain groups."""
    from repro_torch.core.mechanism import signature_groups
    from repro_torch.core.reconstruct import u_chain_factors
    from repro_torch.core.residual import sub_matrix
    out = []
    for dims, cl in signature_groups(plan.domain, plan.cliques).items():
        if dims:
            out.append(([sub_matrix(n) for n in dims], dims, 2 * len(cl),
                        None, "measure"))
    for dims, cl in signature_groups(plan.domain, plan.workload.cliques).items():
        if dims:
            out.append((u_chain_factors(plan.domain, cl[0]), dims, len(cl),
                        None, "reconstruct"))
    return out


def fresh_tuning(name):
    """An empty tuning cache directory under build/ and an empty registry,
    so that no earlier pick can hide the tuner."""
    import tempfile
    from repro_torch.kernels.autotune import reset_registry
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = tempfile.mkdtemp(
        prefix=f"autotune_{name}_", dir=root)
    reset_registry()


def phase_autotune(card, groups, adult):
    """[autotune]: pretune the Synth-10^100 and Adult chain groups in measure
    mode (float32, bfloat16 and float16 offered); each group's pick against
    the model's first pick.  Then the times per call (CUDA events) of
    Synth's two 3-way chains under REPRO_KERNEL_AUTOTUNE=off and =model.
    Returns the kernel
    counts of the pretuning (the tuned path's own launches)."""
    from repro_torch.kernels.autotune import pretune, tune_chain
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    dtypes = ("float32", "bfloat16", "float16")
    fresh_tuning("measure")
    picks, counts = [], None
    reset_chain_stats()
    for gname, chains in groups:
        t0 = time.perf_counter()
        first = [tune_chain(f, d, b, e, dtypes=dtypes, device="cuda",
                            mode="model", persist=False)
                 for f, d, b, e, _ in chains]
        got = pretune([(f, d, b, e) for f, d, b, e, _ in chains],
                      device="cuda", mode="measure", dtypes=dtypes)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = 0
        for (f, d, b, e, role), m, g in zip(chains, first, got):
            agree = (m.rows, m.compute_dtype, m.fused) == \
                (g.rows, g.compute_dtype, g.fused)
            same += agree
            picks.append(dict(group=gname, dims=list(d), batch=b, role=role,
                              rows=g.rows, compute_dtype=g.compute_dtype,
                              fused=g.fused, model_rows=m.rows,
                              model_dtype=m.compute_dtype,
                              model_fused=m.fused,
                              predicted_ms=m.predicted_s * 1e3,
                              measured_ms=g.predicted_s * 1e3,
                              model_first=agree))
            if gname.startswith("synth"):
                print(f"[autotune] {gname} {role} {tuple(d)} x {b}: measured "
                      f"pick rows {g.rows} {g.compute_dtype} "
                      f"{'fused' if g.fused else 'per-axis'} {g.predicted_s * 1e3:.4f} ms; "
                      f"model pick rows {m.rows} {m.compute_dtype} "
                      f"{'fused' if m.fused else 'per-axis'} predicted "
                      f"{m.predicted_s * 1e3:.4f} ms | {card}")
        mine = [p for p in picks if p["group"] == gname]
        by = {}
        for p in mine:
            k = f"{p['compute_dtype']}/{'fused' if p['fused'] else 'per-axis'}"
            by[k] = by.get(k, 0) + 1
        print(f"[autotune] {gname}: {len(mine)} groups tuned in {secs:.3f} s; "
              f"picks {by}; measured winner was the model's first pick for "
              f"{same} of {len(mine)}; sum of predicted "
              f"{sum(p['predicted_ms'] for p in mine):.3f} ms vs measured "
              f"{sum(p['measured_ms'] for p in mine):.3f} ms")
    counts = chain_stats()
    print(f"[autotune] launches while tuning: {counts}")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "autotune_picks.json"), "w") as fh:
        json.dump(dict(card=card, picks=picks), fh, indent=1)

    # model mode must not slow the main path: Synth's two 3-way chains
    from repro_torch.core.reconstruct import u_chain_factors
    from repro_torch.core.residual import sub_matrix
    from repro_torch.data.tabular import synth_domain
    n3 = math.comb(SYNTH_D, 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mode_ms = {}
    for label, facs, batch in (
            ("measure", [sub_matrix(10)] * 3, 2 * n3),
            ("reconstruct", u_chain_factors(synth_domain(10, 3), (0, 1, 2)), n3)):
        x = torch.randn((batch, 1000), generator=gen, device="cuda")
        times, devs, clks = {"off": [], "model": []}, {"off": [], "model": []}, []
        for mode in ("off", "model", "model", "off", "off", "model"):
            os.environ["REPRO_KERNEL_AUTOTUNE"] = mode
            fresh_tuning("modes")
            call = lambda: fused_chain_matvec(  # noqa: E731,B023
                facs, x, (10, 10, 10), allow_narrow=label == "reconstruct")
            # The gate reads CUDA events over back-to-back calls: a chain
            # of this size keeps the card busy between calls, and events,
            # unlike the profiler, drop no launch (see ``profiled``).
            times[mode].append(time_ms(call, 10))
            devs[mode].append(device_ms(call, 10)[0])
            clks.append(clocks())
        os.environ.pop("REPRO_KERNEL_AUTOTUNE")
        # medians of three alternated runs
        off, model = (sorted(times[m])[1] for m in ("off", "model"))
        mode_ms[label] = (off, model)
        print(f"[autotune] Synth-10^{SYNTH_D} 3-way {label} chain, CUDA events "
              f"per call: off {off:.4f} ms, model {model:.4f} ms (ratio "
              f"{model / off:.3f}; runs {times}; profiler device ms {devs}; "
              f"clocks after each run {clks}) | {card}")
        if not model <= 1.1 * off:
            raise AssertionError(f"model mode slowed the {label} chain: "
                                 f"{model:.4f} vs {off:.4f} ms")
        del x
        torch.cuda.empty_cache()

    # The Adult release's device time under each mode: the model re-routes
    # some chains (rows, per-axis) that the untuned plan fuses.
    from repro_torch.engine import MarginalEngine
    adult_plan, adult_margs = adult
    rel = {"off": [], "model": []}
    for mode in ("off", "model", "model", "off"):
        os.environ["REPRO_KERNEL_AUTOTUNE"] = mode
        fresh_tuning("release")
        eng = MarginalEngine(adult_plan, device="cuda")
        kern, copy = device_ms(lambda: eng.release(  # noqa: B023
            adult_margs, torch.Generator("cuda").manual_seed(SEED)), 1)
        rel[mode].append((kern, copy, eng.stats.fallback_chains))
    os.environ.pop("REPRO_KERNEL_AUTOTUNE")
    print(f"[autotune] Adult release device time (kernels ms, copies ms, "
          f"per-axis chains) under off {rel['off']} and model {rel['model']} "
          f"| {card}")
    return counts, picks, mode_ms


def phase_adult_bf16(card, adult, plan, margs):
    """[adult-bf16]: the Adult <=3-way release under model mode with
    REPRO_KERNEL_COMPUTE_DTYPES=bfloat16: measure chains at float32,
    reconstruct chains that fit the fused kernel at bf16, every table within
    rel 3e-2 of its group's max |fp32 table| (the float32 reconstruct of the
    same measurements).  Returns the kernel counts of the release."""
    from repro_torch.core.mechanism import signature_groups
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.autotune import tune_chain
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    fresh_tuning("bf16")
    os.environ["REPRO_KERNEL_COMPUTE_DTYPES"] = "bfloat16"
    try:
        reset_chain_stats()
        t0 = time.perf_counter()
        eng = MarginalEngine(plan, device="cuda")
        t1 = time.perf_counter()
        tables, meas = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = chain_stats()
        rows = eng.chain_plans()
    finally:
        os.environ.pop("REPRO_KERNEL_COMPUTE_DTYPES")
    fresh_tuning("fp32")
    eng32 = MarginalEngine(plan, device="cuda")
    t3 = time.perf_counter()
    tables32 = eng32.reconstruct(meas)
    t4 = time.perf_counter()
    rows32 = eng32.chain_plans()
    measure_rows = [r for r in rows if r["role"] == "measure"]
    recon = [r for r in rows if r["role"] == "reconstruct"]
    if any(r["compute_dtype"] != "float32" for r in measure_rows):
        raise AssertionError("a measure chain was planned narrow")
    if any(r["fused"] and r["compute_dtype"] != "bfloat16" for r in recon):
        raise AssertionError("a fused reconstruct chain is not at bfloat16")
    if not counts["narrow_launches"] > 0:
        raise AssertionError(f"the narrow kernel never ran: {counts}")
    fused16 = sum(r["fused"] for r in recon)
    fused32 = sum(r["fused"] for r in rows32 if r["role"] == "reconstruct")
    from repro_torch.kernels.kron_matvec.fused import plan_chain
    fit = {dt: sum(plan_chain(f, d, b, compute_dtype=dt).fused_ok
                   for f, d, b, _e, role in engine_chains(plan)
                   if role == "reconstruct")
           for dt in ("float32", "bfloat16")}
    worst_rel = worst_sd = 0.0
    sd = dict(zip(plan.workload.cliques, np.sqrt(plan.variances_array())))
    for _dims, group in signature_groups(plan.domain,
                                         plan.workload.cliques).items():
        scale = max(max(float(np.abs(tables32[c]).max()) for c in group), 1.0)
        for c in group:
            diff = float(np.abs(tables[c] - tables32[c]).max())
            worst_rel = max(worst_rel, diff / scale)
            worst_sd = max(worst_sd, diff / sd[c])
    # what the model picks with float32 offered beside bfloat16
    both = {}
    for f, d, b, e, role in engine_chains(plan):
        if role == "reconstruct":
            cfg = tune_chain(f, d, b, e, dtypes=("float32", "bfloat16"),
                             device="cuda", mode="model", persist=False)
            k = f"{cfg.compute_dtype}/{'fused' if cfg.fused else 'per-axis'}"
            both[k] = both.get(k, 0) + 1
    print(f"[adult-bf16] engine {t1 - t0:.3f} s, release {t2 - t1:.3f} s "
          f"(float32 reconstruct of the same measurements {t4 - t3:.3f} s); "
          f"{len(measure_rows)} measure chains all float32; reconstruct "
          f"chains fused at bfloat16 {fused16} of {len(recon)} (float32: "
          f"{fused32} fused), so {fused16 - fused32} moved from per-axis to "
          f"fused; {fit['bfloat16']} fit a block at bf16, {fit['float32']} at "
          f"float32; launches {counts}")
    print(f"[adult-bf16] worst table vs float32: rel {worst_rel:.3e} of its "
          f"group's max (bound {BF16_RELEASE_TOL}), {worst_sd:.4f} sigma; "
          f"float32,bfloat16 offered, the model picks {both} | {card}")
    if not worst_rel <= BF16_RELEASE_TOL:
        raise AssertionError(f"a bf16 table is {worst_rel:.3e} from float32")
    return counts


def phase_exact_edge(card):
    """The secure H chain at its float32 bound: (10, 10), all of
    ||v||_1 = floor((2^24 - 1) / 4000) in one cell, on the fused kernel and
    on a forced per-axis route; both must equal the int64 H exactly.  One
    count more sends a DiscreteEngine's group to the int64 tier."""
    from repro_torch.core import Domain, all_kway, select_sum_of_variances
    from repro_torch.core.discrete import h_factors
    from repro_torch.core.kron import kron_matvec_np_batched
    from repro_torch.engine import DiscreteEngine
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    dims = (10, 10)
    l1 = (F32_EXACT - 1) // (400 * 10)
    vs = np.zeros((1, 100))
    vs[0, 37] = l1
    want = kron_matvec_np_batched(h_factors(dims, np.int64),
                                  vs.astype(np.int64), dims).astype(np.float64)
    x = torch.as_tensor(vs, dtype=torch.float32, device="cuda")
    for route, budget, launch in (("fused", 232448, "fused_launches"),
                                  ("per-axis", 16, "axis_launches")):
        reset_chain_stats()
        got = fused_chain_matvec(h_factors(dims), x, dims, smem_budget=budget)
        torch.cuda.synchronize()
        if not chain_stats()[launch] > 0:
            raise AssertionError(f"the {route} route did not launch: "
                                 f"{chain_stats()}")
        if not np.array_equal(got.cpu().numpy().astype(np.float64), want):
            raise AssertionError(f"H at the float32 bound differs from int64 "
                                 f"H on the {route} route")
    plan = select_sum_of_variances(all_kway(Domain.create([10, 10]), 2), 1.0)
    eng = DiscreteEngine(plan, device="cuda")
    eng._h_transform(vs, dims)
    vs[0, 37] = l1 + 1
    eng._h_transform(vs, dims)
    if not (eng.stats.device_h_groups == 1 and eng.stats.exact_h_groups == 1):
        raise AssertionError(f"the H tiers do not switch at the bound: "
                             f"{eng.stats}")
    print(f"[exact-edge] H on (10, 10) with ||v||_1 = {l1} in one cell "
          f"(bound {l1 * 4000} < 2^24): fused and per-axis routes equal int64 "
          f"H bit for bit; ||v||_1 = {l1 + 1} takes the int64 tier | {card}")


def maxvar_gap(plan):
    """(primal, dual, relative gap) of a max-variance plan at its dual
    point, in float64 on the host."""
    from repro_torch.core.select import _maxvar_eval_fp64
    t = plan.table
    cw = t.weight_vector(None, default_to_workload=True)
    primal, _u, dual = _maxvar_eval_fp64(plan.mu, t.p, t.inc_rows, t.inc_cols,
                                         t.inc_vals, cw, plan.pcost, t.n, t.m)
    return primal, dual, (primal - dual) / primal


def repeat_check(name, label, plans):
    """Every plan's sigma and loss equal to the first's, bit for bit."""
    same = all(np.array_equal(p.sigma, plans[0].sigma)
               and p.loss_value == plans[0].loss_value for p in plans)
    print(f"[{name}] {label}: {len(plans)} calls, sigma and loss "
          f"bit-identical {same} (loss {plans[0].loss_value!r})")
    if not same:
        raise AssertionError(f"{label}: two calls gave different plans")


def phase_select_device(card, adult_wk, synth_wk, synth_sov):
    """[select-device]: the device max-variance loop on the card.  Returns
    Adult's max-variance optimum (the numpy loop's loss)."""
    import importlib
    # the module (the package's ``select`` attribute is the function)
    sel = importlib.import_module("repro_torch.core.select")
    iters = [0]
    run_chunk = sel._maxvar_run_chunk

    def counted(*a):
        iters[0] += a[-1]
        return run_chunk(*a)
    sel._maxvar_run_chunk = counted
    t0 = time.perf_counter()
    host = sel.select_max_variance(adult_wk, 1.0, backend="numpy")
    t1 = time.perf_counter()
    dev = sel.select_max_variance(adult_wk, 1.0, backend="device",
                                  device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    adult_iters = iters[0]
    _p, _d, g_host = maxvar_gap(host)
    _p, _d, g_dev = maxvar_gap(dev)
    print(f"[select-device] Adult <=3-way ({adult_wk.domain.n_attrs} attrs, "
          f"{sel.plan_table(adult_wk).inc_vals.size} incidence entries): "
          f"numpy loss {host.loss_value:.9g} (gap {g_host:.3e}, "
          f"{t1 - t0:.3f} s), device loss {dev.loss_value:.9g} (gap "
          f"{g_dev:.3e}, {adult_iters} iterations, {t2 - t1:.3f} s) | {card}")
    if not abs(dev.loss_value - host.loss_value) <= \
            (g_host + g_dev) * host.loss_value + 1e-12 * host.loss_value:
        raise AssertionError("device and numpy max-variance disagree beyond "
                             "their gaps")
    for where in ("cuda", "cpu"):
        again = [sel.select_max_variance(adult_wk, 1.0, backend="device",
                                         device=where) for _ in range(2)]
        repeat_check("select-device", f"Adult device loop on {where}", again)
    iters[0] = 0
    t0 = time.perf_counter()
    sdev = sel.select_max_variance(synth_wk, 1.0, backend="device",
                                   device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sel._maxvar_run_chunk = run_chunk
    _p, _d, g = maxvar_gap(sdev)
    sov_max = synth_sov.max_variance()
    print(f"[select-device] Synth-10^{SYNTH_D} <=3-way "
          f"({sel.plan_table(synth_wk).inc_vals.size} incidence entries): "
          f"device loop {secs:.3f} s, {iters[0]} iterations, loss "
          f"{sdev.loss_value:.9g}, gap {g:.3e}; SoV plan's max variance "
          f"{sov_max:.9g} | {card}")
    if not sdev.loss_value <= sov_max:
        raise AssertionError("the device max-variance plan is worse than SoV")
    return host.loss_value


def phase_select_convex(card, adult_wk, opt):
    """[select-convex]: select_convex on Adult on the card and on the CPU,
    and a user callable (the l2 norm of the variance vector)."""
    from repro_torch.core import select, select_convex
    out = {}
    for where, dev in (("card", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        plan = select_convex(adult_wk, 1.0, loss="max_variance", device=dev)
        out[where] = (plan.loss_value, time.perf_counter() - t0)
        if not (plan.loss_value >= opt * (1 - 1e-9)
                and abs(plan.pcost - 1.0) <= 1e-9):
            raise AssertionError(f"select_convex on {dev} below the optimum "
                                 f"or off budget: {plan.loss_value}, "
                                 f"{plan.pcost}")
        repeat_check("select-convex", f"max_variance on {dev}", [plan] + [
            select_convex(adult_wk, 1.0, loss="max_variance", device=dev)
            for _ in range(2)])

    def l2_of_variances(var):
        return torch.sqrt(torch.sum(var * var))
    t0 = time.perf_counter()
    p2 = select(adult_wk, 1.0, objective="convex", loss=l2_of_variances,
                device="cuda")
    secs = time.perf_counter() - t0
    repeat_check("select-convex", "l2 callable on cuda", [p2] + [
        select(adult_wk, 1.0, objective="convex", loss=l2_of_variances,
               device="cuda") for _ in range(2)])
    got = float(np.sqrt(np.sum(p2.variances_array() ** 2)))
    print(f"[select-convex] Adult <=3-way max_variance, 3000 Adam steps: card "
          f"{out['card'][1]:.3f} s, loss/optimum {out['card'][0] / opt:.6f}; "
          f"cpu {out['cpu'][1]:.3f} s, loss/optimum {out['cpu'][0] / opt:.6f}; "
          f"l2 callable on the card {secs:.3f} s, loss {p2.loss_value:.9g} "
          f"(float64 recheck {got:.9g}) | {card}")
    if not (math.isfinite(p2.loss_value)
            and abs(p2.loss_value - got) <= 1e-9 * got):
        raise AssertionError("the callable's loss_value is not its float64 value")


def sigma_bar_plan(plan, eng):
    """The plan with every sigma^2_A replaced by the engine's rationalized
    sigma-bar^2_A: the variances the discrete release really has."""
    import dataclasses
    bar = plan.sigma.copy()
    for c, sb in eng.sigma_bars.items():
        bar[plan.table.index[c]] = float(sb) ** 2
    return dataclasses.replace(plan, sigma=bar)


def secure_phase(name, card, plan, margs, k_sigma):
    """One secure release on the card with the kernel counts reset just
    before it and read just after; H checked bit for bit on every
    device-tier group; seconds split into draws, H, Y-dagger, reconstruct;
    then device ms by kernel of one more measure + reconstruct with the
    draws replaced by zeros."""
    import repro_torch.core.dgauss as dg
    from repro_torch.core.discrete import h_factors
    from repro_torch.core.kron import kron_matvec_np_batched
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    secs = {"draws": 0.0, "H": 0.0, "Y": 0.0, "reconstruct": 0.0}
    t0 = time.perf_counter()
    eng = plan.engine(secure=True, digits=4, device="cuda")
    secs["engine"] = time.perf_counter() - t0
    rows = eng.chain_plans()
    if any(r["compute_dtype"] != "float32" for r in rows
           if r["role"] == "measure"):
        raise AssertionError("an H or Y-dagger chain was planned narrow")
    raw, checked = {}, []
    device_chain, h, y = eng._device_chain, eng._h_transform, eng._y_transform
    sample, recon = dg.sample, eng.reconstruct

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t
            return out
        return run

    def stash(factors, x, dims):
        raw["y"] = device_chain(factors, x, dims)
        return raw["y"]

    def h_checked(vs, dims):
        before = eng.stats.device_h_groups
        out = timed("H", h)(vs, dims)
        if eng.stats.device_h_groups > before:
            want = kron_matvec_np_batched(h_factors(dims, np.int64),
                                          np.rint(vs).astype(np.int64), dims)
            if not np.array_equal(raw["y"], want.astype(np.float64)):
                raise AssertionError(f"device H differs from int64 H on {dims}")
            checked.append((dims, vs.shape[0]))
        return out
    eng._device_chain, eng._h_transform = stash, h_checked
    eng._y_transform = timed("Y", y)
    eng.reconstruct = timed("reconstruct", recon)
    dg.sample = timed("draws", sample)
    torch.cuda.reset_peak_memory_stats()
    reset_chain_stats()
    t0 = time.perf_counter()
    tables, _meas = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    secs["release"] = time.perf_counter() - t0
    counts = chain_stats()
    dg.sample = sample
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    worst = check_tables(sigma_bar_plan(plan, eng), tables, margs, k_sigma)
    secs["check"] = time.perf_counter() - t0
    st = eng.stats
    print(f"[{name}] closure {len(plan.cliques)} cliques, workload "
          f"{len(plan.workload.cliques)} marginals / "
          f"{sum(plan.domain.n_cells(c) for c in plan.workload.cliques)} "
          f"cells, {st.measure_signatures} measure + "
          f"{st.reconstruct_signatures} reconstruct groups; tiers: "
          f"device_h_groups {st.device_h_groups}, exact_h_groups "
          f"{st.exact_h_groups}, host_y_groups {st.host_y_groups}; device-tier "
          f"H equal to int64 H bit for bit in {len(checked)} groups "
          f"{[d for d, _ in checked]}")
    print(f"[{name}] seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                            secs.items())
          + f"; peak device memory {peak / 2**30:.2f} GiB")
    print(f"[{name}] worst table {worst:.3f} sigma-bar (bound {k_sigma}); "
          f"launches {counts}")
    if counts["narrow_launches"]:
        raise AssertionError(f"a narrow launch in the secure release: {counts}")
    if not checked or len(checked) != st.device_h_groups:
        raise AssertionError("not every device-tier group was checked")
    zeros = lambda g2, n, r: np.zeros(n, np.int64)  # noqa: E731
    ms = kernel_ms_by_name(lambda: eng.reconstruct(eng.measure(
        margs, torch.Generator("cuda").manual_seed(SEED),
        _noise_override=zeros)))
    print(f"[{name}] device ms of one more measure + reconstruct (draws "
          f"replaced by zeros) by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
          + f" | {card}")
    return counts, eng


def phase_secure_adult(card, adult, plan):
    from repro_torch.data.tabular import marginals_from_records, synthetic_records
    margs = marginals_from_records(adult, plan.cliques,
                                   synthetic_records(adult, ADULT_RECORDS, SEED))
    counts, eng = secure_phase("secure-adult", card, plan, margs, 6.0)
    if not (counts["fused_launches"] > 0 and counts["axis_launches"] > 0):
        raise AssertionError(f"the secure Adult release skipped a kernel: "
                             f"{counts}")
    if not (eng.stats.device_h_groups > 0 and eng.stats.exact_h_groups > 0):
        raise AssertionError(f"the secure Adult release missed a tier: "
                             f"{eng.stats}")
    return counts


def phase_secure_synth2(card, synth):
    from repro_torch.core import all_kway, select_sum_of_variances
    from repro_torch.data.tabular import marginals_from_records, synthetic_records
    plan = select_sum_of_variances(all_kway(synth, 2, include_lower=True), 1.0)
    margs = marginals_from_records(synth, plan.cliques,
                                   synthetic_records(synth, SYNTH2_RECORDS, SEED))
    counts, eng = secure_phase("secure-synth2", card, plan, margs, 7.0)
    if not (counts["fused_launches"] > 0 and eng.stats.exact_h_groups == 0):
        raise AssertionError(f"the secure Synth release left the device tier "
                             f"or the fused kernel: {eng.stats}, {counts}")
    return counts, eng, margs


CG_ATOL = 5e-5          # of max|raw|: the JAX package's device-vs-host bound
CG_PROFILE_ITERS = 10   # at most this many CG iterations under the profiler
TREE_RECORDS = 1_000_000


class ReleaseStages:
    """Stage clock of the release subsystem while active: the operator's
    host build, rhs (host fp64), the device set-up (index H2D, segment
    map), the CG on the card, marginals (host fp64) and the projection,
    each timed after a ``torch.cuda.synchronize()``; ``solves`` keeps every
    ConsistentRelease (iterations, relative residual, total).  The
    functions are wrapped where the package looks them up and restored on
    exit."""

    def __init__(self):
        self.secs = dict(operator=0.0, rhs=0.0, setup=0.0, cg=0.0,
                         marginals=0.0, projection=0.0)
        self.solves = []
        self._solve = 0.0

    def _timed(self, key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if key == "solve":
                self._solve += dt
                self.solves.append(out)
            else:
                self.secs[key] += dt
            return out
        return run

    def __enter__(self):
        import repro_torch.release as rel
        import repro_torch.release.consistency as cons
        import repro_torch.release.nonneg as nonneg
        op = cons.ConsistencyOperator
        self._saved = [(op, "__init__", "operator"), (op, "rhs_np", "rhs"),
                       (op, "device_fns", "setup"),
                       (op, "marginals_np", "marginals"),
                       (nonneg, "project_nonneg", "projection"),
                       (rel, "solve_consistency", "solve"),
                       (nonneg, "solve_consistency", "solve")]
        self._saved = [(obj, name, getattr(obj, name), key)
                       for obj, name, key in self._saved]
        for obj, name, fn, key in self._saved:
            setattr(obj, name, self._timed(key, fn))
        return self

    def __exit__(self, *exc):
        for obj, name, fn, _key in self._saved:
            setattr(obj, name, fn)
        self.secs["cg"] = self._solve - (self.secs["operator"]
                                         + self.secs["rhs"]
                                         + self.secs["setup"])

    def line(self) -> str:
        its = [(s.iterations, s.rel_residual) for s in self.solves]
        return (", ".join(f"{k} {v:.3f}" for k, v in self.secs.items())
                + f"; CG iterations and relative residual {its}")


def timed_engine(eng, secs):
    """Time the engine's measure and reconstruct calls into ``secs``."""
    for step in ("measure", "reconstruct"):
        def timed(*a, _fn=getattr(eng, step), _step=step, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            secs[_step] = time.perf_counter() - t
            return out
        setattr(eng, step, timed)


def same_family(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[c], b[c]) for c in a)


def family_gap(got, want) -> float:
    """max |got - want| over a family, over max |want|."""
    scale = max(max(float(np.abs(t).max()) for t in want.values()), 1.0)
    return max(float(np.abs(got[c] - want[c]).max()) for c in want) / scale


def postprocess_twice(name, card, eng, margs, mode, **kw):
    """``eng.release(postprocess=mode)`` twice from one seed, stages timed,
    the kernel counts of the first call; the two families bit-identical."""
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    fams, counts, stages = [], None, None
    for i in range(2):
        secs = {}
        timed_engine(eng, secs)
        reset_chain_stats()
        with ReleaseStages() as st:
            t0 = time.perf_counter()
            tables, _ = eng.release(margs, torch.Generator(
                "cuda").manual_seed(SEED), postprocess=mode, **kw)
            secs["release"] = time.perf_counter() - t0
        if i == 0:
            counts, stages = chain_stats(), st
        fams.append(tables)
        print(f"[{name}] {mode} call {i + 1} seconds: "
              + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
              + f"; {st.line()} | {card}")
    same = same_family(*fams)
    print(f"[{name}] two {mode} calls from one seed bit-identical: {same}")
    if not same:
        raise AssertionError(f"two {mode} releases from one seed differ")
    return fams[0], counts, stages


def cg_kernel_ms(name, card, plan, tables):
    """Device ms of one CG solve by kernel (profiler; at most
    CG_PROFILE_ITERS iterations, on an operator whose device set-up is
    done)."""
    from repro_torch.release import ConsistencyOperator, solve_consistency
    op = ConsistencyOperator(plan)
    solve_consistency(plan, tables, device="cuda", operator=op, maxiter=1)
    done = []
    ms = kernel_ms_by_name(lambda: done.append(solve_consistency(
        plan, tables, device="cuda", operator=op, maxiter=CG_PROFILE_ITERS)))
    print(f"[{name}] device ms of one CG solve ({done[-1].iterations} "
          f"iterations) by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
          + f" | {card}")
    return op


def phase_release_adult(card, plan, margs):
    """[release-adult]: consistent (6 sigma, == raw, two calls bit-identical,
    the card's float32 CG against the host fp64 CG), nonneg (cells >= 0,
    sums == the fitted total) and synthesize(48,842) on Adult <=3-way."""
    from repro_torch.engine import MarginalEngine
    from repro_torch.release import (project_nonneg, solve_consistency,
                                     synth_report)
    eng = MarginalEngine(plan, device="cuda")
    raw, _ = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
    cons, counts, _st = postprocess_twice("release-adult", card, eng, margs,
                                          "consistent")
    worst = check_tables(plan, cons, margs, 6.0)
    gap = family_gap(cons, raw)
    op = cg_kernel_ms("release-adult", card, plan, raw)
    t0 = time.perf_counter()
    dev = solve_consistency(plan, raw, device="cuda", operator=op)
    t1 = time.perf_counter()
    host = solve_consistency(plan, raw, backend="host", operator=op)
    t2 = time.perf_counter()
    r_err = float(np.abs(dev.r - host.r).max()) / max(
        float(np.abs(host.r).max()), 1.0)
    print(f"[release-adult] consistent: worst table {worst:.3f} sigma (bound "
          f"6), max|consistent - raw| / max|raw| {gap:.3e} (bound {CG_ATOL}); "
          f"card float32 CG {t1 - t0:.3f} s, {dev.iterations} iterations, rel "
          f"residual {dev.rel_residual:.3e}; host fp64 CG {t2 - t1:.3f} s, "
          f"{host.iterations} iterations; max|r_card - r_host| / max|r_host| "
          f"{r_err:.3e} (bound {CG_ATOL}); launches {counts}")
    if not (gap <= CG_ATOL and r_err <= CG_ATOL):
        raise AssertionError("the consistent Adult family left the raw one "
                             "or the host CG")
    secs = {}
    timed_engine(eng, secs)
    with ReleaseStages() as st:
        nn, _ = eng.release(margs, torch.Generator("cuda").manual_seed(SEED),
                            postprocess="nonneg")
    total = st.solves[-1].total
    off = max(abs(float(t.sum()) - total) / np.spacing(total)
              for t in nn.values())
    neg = sum(int((t < 0).sum()) for t in nn.values())
    again = [project_nonneg(plan.domain, cons, total, device="cuda")
             for _ in range(2)]
    t0 = time.perf_counter()
    recs = eng.synthesize(ADULT_RECORDS, torch.Generator("cuda").manual_seed(SEED))
    secs["synthesis"] = time.perf_counter() - t0
    sizes = np.array(plan.domain.sizes)
    rep = synth_report(plan.domain, nn, recs)
    print(f"[release-adult] nonneg seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; {st.line()}; negative cells {neg}, worst |sum - total| "
          f"{off:.1f} ulp of the fitted total {total:.6f}; the card's "
          f"projection twice bit-identical {same_family(*again)}; "
          f"synthesize({ADULT_RECORDS}) {recs.shape} {recs.dtype}: "
          f"{rep.summary()} | {card}")
    if neg or off > 2 or not same_family(*again):
        raise AssertionError("the nonneg Adult family is negative, off its "
                             "total, or not reproducible")
    if not (recs.shape == (ADULT_RECORDS, plan.domain.n_attrs)
            and recs.dtype == np.int32 and recs.min() >= 0
            and np.all(recs.max(axis=0) < sizes)):
        raise AssertionError("synthetic Adult records out of shape or range")
    return counts


def chain_implied_marginals(domain, tables, n_attrs):
    """The (i, i+1) marginals of the joint that junction sampling draws
    from on the chain (0,1),...,(n-2,n-1): p(x_0) from table (0,1), then
    p(x_i, x_i+1) = p(x_i) * p(x_i+1 | x_i) with the conditional from
    table (i,i+1), the sampler's own _conditional_table.  Where the tables
    agree on every shared attribute this is the tables themselves."""
    from repro_torch.release.synth import _conditional_table
    out = {}
    p = _conditional_table(domain, tables[(0, 1)], (0, 1), 0, ())[0]
    for i in range(n_attrs - 1):
        c = (i, i + 1)
        cond = _conditional_table(domain, tables[c], c, i + 1, (i,))
        joint = p[:, None] * cond
        out[c] = joint.reshape(-1) * float(np.asarray(tables[c]).sum())
        p = joint.sum(axis=0)
    return out


def phase_release_adult_tree(card, adult, records):
    """[release-adult-tree]: the 13-clique chain (0,1),...,(12,13) on
    Adult's domain, nonneg then synthesize(1,000,000).  Gates: max_tv < 0.05
    against the released tables, and chi-square at z = 6 against the
    marginals of the joint junction sampling draws from (exact on a
    tree).  The chi-square against the released tables is printed: the
    projection clips cells per table, so neighbouring tables disagree on
    their shared attribute and the sampler's joint is not theirs (the JAX
    package's nonneg_release does the same; tests/test_torch_release.py)."""
    from repro_torch.core import select_sum_of_variances
    from repro_torch.core.domain import MarginalWorkload
    from repro_torch.data.tabular import marginals_from_records
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    from repro_torch.release import synth_report
    wk = MarginalWorkload(adult, tuple((i, i + 1)
                                       for i in range(adult.n_attrs - 1)))
    plan = select_sum_of_variances(wk, 1.0)
    margs = marginals_from_records(adult, plan.cliques, records)
    eng = MarginalEngine(plan, device="cuda")
    secs = {}
    timed_engine(eng, secs)
    reset_chain_stats()
    with ReleaseStages() as st:
        nn, _ = eng.release(margs, torch.Generator("cuda").manual_seed(SEED),
                            postprocess="nonneg")
    counts = chain_stats()
    t0 = time.perf_counter()
    recs = eng.synthesize(TREE_RECORDS, torch.Generator("cuda").manual_seed(SEED))
    secs["synthesis"] = time.perf_counter() - t0
    rep = synth_report(adult, nn, recs)
    implied = synth_report(adult, chain_implied_marginals(
        adult, nn, adult.n_attrs), recs)

    def excess(r):
        return max(c.chi2 - c.dof - 6.0 * math.sqrt(2.0 * c.dof)
                   for c in r.checks)
    print(f"[release-adult-tree] seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; {st.line()}; launches {counts}")
    print(f"[release-adult-tree] synthesize({TREE_RECORDS}): against the "
          f"released tables {rep.summary()}, chi-square ok(z=6) {rep.ok(6.0)} "
          f"(worst excess over the bound {excess(rep):.1f}); against the "
          f"sampler's chain joint {implied.summary()}, ok(z=6) "
          f"{implied.ok(6.0)} (worst excess {excess(implied):.1f}) | {card}")
    if not (rep.max_tv < 0.05 and implied.ok(6.0)):
        raise AssertionError("tree synthesis off its tables or its joint")
    return counts


def phase_release_synth(card, plan, margs):
    """[release-synth]: Synth-10^100 <=3-way, postprocess="consistent"
    twice (7 sigma, == raw, bit-identical), peak device memory."""
    from repro_torch.engine import MarginalEngine
    eng = MarginalEngine(plan, device="cuda")
    raw, _ = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    cons, counts, _st = postprocess_twice("release-synth", card, eng, margs,
                                          "consistent")
    peak = torch.cuda.max_memory_allocated()
    worst = check_tables(plan, cons, margs, 7.0)
    gap = family_gap(cons, raw)
    del raw
    cg_kernel_ms("release-synth", card, plan, cons)
    print(f"[release-synth] {len(plan.cliques)} closure cliques; worst table "
          f"{worst:.3f} sigma (bound 7); max|consistent - raw| / max|raw| "
          f"{gap:.3e} (bound {CG_ATOL}); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {counts} | {card}")
    if not gap <= CG_ATOL:
        raise AssertionError("the consistent Synth family left the raw one")
    return counts


def phase_release_secure(card, eng, margs):
    """[release-secure]: the [secure-synth2] engine with postprocess=
    "nonneg"; every table keeps the measured integer total."""
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    secs = {}
    timed_engine(eng, secs)
    reset_chain_stats()
    with ReleaseStages() as st:
        t0 = time.perf_counter()
        nn, meas = eng.release(margs, torch.Generator("cuda").manual_seed(SEED),
                               postprocess="nonneg")
        secs["release"] = time.perf_counter() - t0
    counts = chain_stats()
    measured = float(np.asarray(meas[()].omega).reshape(-1)[0])
    sums = [float(t.sum()) for t in nn.values()]
    kept = sum(round(v) == int(measured) for v in sums)
    exact = sum(v == measured for v in sums)
    neg = sum(int((t < 0).sum()) for t in nn.values())
    print(f"[release-secure] seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; {st.line()}; measured integer total {measured:.0f}: kept by "
          f"{kept} of {len(sums)} tables (float sum equal to it in {exact}); "
          f"negative cells {neg}; launches {counts} | {card}")
    if not (measured.is_integer() and kept == len(sums) and neg == 0):
        raise AssertionError("a secure nonneg table lost the measured total")
    return counts


DNC_D = 500            # [dnc-d500]: the README's headline D&C width
DNC_AUTO_D = 200       # [dnc-d200]: all <=3-way, past AUTO_DNC_NNZ
DNC_MASS = 1e6         # records' mass of the mixture marginals
SYNTH_RECORDS = 100_000
OBS_ROUNDS = 4         # [obs]: off/on pairs, alternated


def cuda_gen(seed=SEED):
    return torch.Generator("cuda").manual_seed(seed)


_PLAN_IN_CHILD = """
import json, resource, sys, time
sys.path.insert(0, {src!r})
from repro_torch.core import CompositePlan, Domain, all_kway, select
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
t0 = time.perf_counter()
wk = all_kway(Domain.create([(i % 9) + 2 for i in range({d})]), {k},
              include_lower=True)
t1 = time.perf_counter()
plan = select(wk, 1.0, strategy={strategy!r})
t2 = time.perf_counter()
comp = isinstance(plan, CompositePlan)
print(json.dumps(dict(
    workload_s=t1 - t0, select_s=t2 - t1, composite=comp,
    marginals=len(wk.cliques), est=sum(1 << len(c) for c in wk.cliques),
    blocks=plan.n_blocks if comp else 1,
    straddlers=plan.decomposition.n_straddlers if comp else 0,
    base_gib=base / 2**20,
    peak_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)))
"""


def plan_in_child(d, k, strategy):
    """Start select(all_kway(mixed_domain(d), k), strategy=...) in a child
    Python process; ``plan_in_child_read`` returns its seconds and its peak
    RSS (``base_gib``: the peak after the imports, torch's and what the
    fork inherited included)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    return subprocess.Popen([sys.executable, "-c", _PLAN_IN_CHILD.format(
        src=src, d=d, k=k, strategy=strategy)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def plan_in_child_read(proc):
    out, err = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"the planner's child process exited "
                             f"{proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def mixed_domain(d):
    """d attributes of sizes (i % 9) + 2, as benchmarks/planner_bench.py."""
    from repro_torch.core import Domain
    return Domain.create([(i % 9) + 2 for i in range(d)])


def blocked_workload(d, bs, k):
    """Disjoint groups of ``bs`` attributes, all <=k-way inside each group
    (benchmarks/planner_bench.py's exactly decomposable workload)."""
    from itertools import combinations
    from repro_torch.core import MarginalWorkload
    cl = [()]
    for g in range(0, d, bs):
        for w in range(1, k + 1):
            cl.extend(combinations(range(g, min(g + bs, d)), w))
    return MarginalWorkload(mixed_domain(d), tuple(cl))


def width_index(cliques):
    """(lens, {width: (at, (n_width, width) attribute matrix)}) of a clique
    list, for ``rows_by_width``: built once, passed to every check of one
    release."""
    lens = np.fromiter(map(len, cliques), np.int64, len(cliques))
    per = {}
    for k in np.unique(lens).tolist():
        ids = np.flatnonzero(lens == k)
        at = np.full(len(cliques), -1, np.int64)
        at[ids] = np.arange(len(ids))
        per[k] = (at, np.asarray([cliques[r] for r in ids.tolist()],
                                 np.int64).reshape(len(ids), k))
    return lens, per


def rows_by_width(index, rows):
    """{width: (rows of that width, their (g, width) attribute matrix)}
    from a ``width_index``."""
    lens, per = index
    rows = np.asarray(rows, np.int64).reshape(-1)
    out = {}
    for k in np.unique(lens[rows]).tolist():
        rk = rows[lens[rows] == k]
        at, mat = per[k]
        out[k] = (rk, mat[at[rk]])
    return out


CHECK_CHUNK = 1 << 24          # cells of one stacked batch of tables


def chunks(idx, cells):
    """``idx`` cut into runs of at most CHECK_CHUNK cells of ``cells``
    each."""
    step = max(1, CHECK_CHUNK // max(int(cells), 1))
    return [idx[i:i + step] for i in range(0, len(idx), step)]


def stacked(tables, cliques, rows, cells, what="table"):
    """(g, cells) float64 of ``tables[cliques[r]]`` for ``rows``; raises on
    a table of another shape or a non-finite value."""
    arrs = [tables[cliques[r]] for r in rows.tolist()]
    if any(t.shape != (cells,) for t in arrs):
        raise AssertionError(f"a {what} of {cells} cells has another shape")
    out = np.concatenate(arrs).astype(np.float64, copy=False).reshape(
        len(arrs), cells)
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"a {what} of {cells} cells has non-finite "
                             "values")
    return out


def sigma_dev(plan, tables, exact, rows, index=None):
    """max over ``rows`` of |table - exact| / sigma (the plan's variances);
    rows with one number of cells are checked in batches.  ``index``: the
    workload's ``width_index`` (built here if None)."""
    from repro_torch.core.partition import group_rows
    sd = np.sqrt(plan.variances_array())
    wk = plan.workload.cliques
    sizes = np.asarray(plan.domain.sizes, np.int64)
    worst = 0.0
    for rk, mat in rows_by_width(index or width_index(wk), rows).values():
        cells = np.prod(sizes[mat], axis=1)
        for grp in group_rows(cells[:, None]):
            n = int(cells[grp[0]])
            for part in chunks(rk[grp], n):
                t = stacked(tables, wk, part, n)
                e = stacked(exact, wk, part, n, "exact marginal")
                worst = max(worst, float(np.max(
                    np.abs(t - e).max(axis=1) / sd[part])))
    return worst


def row_finder(cliques, n_attrs):
    """A function from a (g, w) attribute matrix to the rows of
    ``cliques`` equal to its rows (-1 where none is); each width's index is
    built on its first use."""
    lens = np.fromiter(map(len, cliques), np.int64, len(cliques))
    index = {}

    def code(mat):
        if n_attrs ** mat.shape[1] >= 1 << 62:
            raise ValueError(f"cliques of {mat.shape[1]} attributes out of "
                             f"{n_attrs} do not fit one int64 key")
        key = np.zeros(len(mat), np.int64)
        for j in range(mat.shape[1]):
            key = key * n_attrs + mat[:, j]
        return key

    def find(pc):
        w = pc.shape[1]
        if w not in index:
            ids = np.flatnonzero(lens == w)
            key = code(np.asarray([cliques[r] for r in ids.tolist()],
                                  np.int64).reshape(len(ids), w))
            order = np.argsort(key, kind="stable")
            index[w] = (key[order], ids[order])
        keys, ids = index[w]
        if not len(keys):
            return np.full(len(pc), -1, np.int64)
        want = code(pc)
        at = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
        return np.where(keys[at] == want, ids[at], -1)
    return find


def straddler_dev(plan, tables, exact, rows, device="cpu"):
    """max over the straddling ``rows`` of |table - target| / sigma
    (``straddler_check``'s ``worst``)."""
    return straddler_check(plan, tables, exact, rows, device)["worst"]


def straddler_check(plan, tables, exact, rows, device="cpu", again=None,
                    index=None):
    """One pass over the straddling ``rows``.  ``worst``: max of |table -
    target| / sigma.  The target is what the product-of-blocks estimator
    estimates: the outer product of the exact part marginals (summed out of
    the exact table) over N^(parts - 1).  sigma is the estimator's
    first-order (delta-method) deviation, from the parts' variances and
    their covariances through the shared total T: every reconstructed
    marginal holds T/cells in each cell and the blocks' other noise is
    independent, so Cov(P_p, T) = Var T / n_p and Cov(P_p, P_q) = Var T /
    (n_p n_q) for n_p cells of part p.  ``proxy``: max of |table - exact
    marginal| / the plan's proxy sigma (``sigma_dev`` of these rows).
    ``same``: with ``again`` (a second release), whether every table of
    ``rows`` equals its table there.  Rows with one shape and one split of
    their axes into parts are checked in batches, the arithmetic in float64
    torch on ``device``.  ``index``: the workload's ``width_index`` (built
    here if None)."""
    from repro_torch.core.partition import group_rows
    dom = plan.domain
    wk = plan.workload.cliques
    block_of = plan.partition.block_of_array()
    variances = plan.variances_array()
    sizes = np.asarray(dom.sizes, np.int64)
    vt = plan.block_plans[0].marginal_variance(())
    n = float(np.asarray(exact[()], np.float64).reshape(-1)[0])
    find = row_finder(wk, dom.n_attrs)
    worst, proxy, same = 0.0, 0.0, True
    for nd, (rk, mat) in rows_by_width(index or width_index(wk),
                                       rows).items():
        # each axis's part: its block's rank among the row's blocks in order
        blk = block_of[mat]
        first = np.argmax(blk[:, :, None] == blk[:, None, :], axis=2)
        rank = np.cumsum(first == np.arange(nd), axis=1) - 1
        labels = np.take_along_axis(rank, first, axis=1)
        for grp in group_rows(np.concatenate([sizes[mat], labels], axis=1)):
            shape = tuple(sizes[mat[grp[0]]].tolist())
            cells = int(np.prod(shape))
            lab = labels[grp[0]]
            k = int(lab.max()) + 1
            vps = []                # each part's variance, per row
            for p in range(k):
                axes = np.flatnonzero(lab == p)
                pc = mat[grp][:, axes]
                r_pc = find(pc)
                vp = variances[np.maximum(r_pc, 0)]
                for j in np.flatnonzero(r_pc < 0).tolist():
                    vp[j] = plan.block_plans[int(block_of[pc[j, 0]])
                                             ].marginal_variance(
                        tuple(pc[j].tolist()))
                vps.append(vp)
            for part in chunks(np.arange(len(grp)), cells):
                g = len(part)
                rows_p = rk[grp[part]]
                t_np = stacked(tables, wk, rows_p, cells,
                               f"straddler of shape {shape}")
                if again is not None:
                    same = same and np.array_equal(t_np, stacked(
                        again, wk, rows_p, cells, "second release's table"))
                m = torch.from_numpy(stacked(
                    exact, wk, rows_p, cells, "exact marginal")).to(device)
                t = torch.from_numpy(t_np).to(device)
                sd = torch.from_numpy(np.sqrt(variances[rows_p])).to(device)
                proxy = max(proxy, float(torch.max(
                    (t - m).abs().amax(dim=1) / sd)))
                m = m.reshape((g,) + shape)
                parts = []          # (exact part, its variance, its cells)
                for p in range(k):
                    axes = [i for i in range(nd) if lab[i] == p]
                    rest = [i + 1 for i in range(nd) if i not in axes]
                    parts.append((m.sum(dim=rest, keepdim=True) if rest
                                  else m,
                                  torch.from_numpy(vps[p][part]).to(
                                      device).reshape((g,) + (1,) * nd),
                                  int(np.prod([shape[i] for i in axes]))))
                den = n ** (k - 1)
                grads = []          # d target / d part p
                for p in range(k):
                    gp = torch.ones((g,) + shape, dtype=torch.float64,
                                    device=device)
                    for q, (pt, _, _) in enumerate(parts):
                        if q != p:
                            gp = gp * pt
                    grads.append(gp / den)
                target = grads[0] * parts[0][0]
                g_t = -(k - 1) * target / n
                v = g_t ** 2 * vt
                for p, (_, vp, cp) in enumerate(parts):
                    v = v + grads[p] ** 2 * vp + 2 * grads[p] * g_t * vt / cp
                    for q, (_, _, cq) in enumerate(parts):
                        if q != p:
                            v = v + grads[p] * grads[q] * vt / (cp * cq)
                worst = max(worst, float(torch.max(
                    (t.reshape(m.shape) - target).abs() / v.sqrt())))
    return {"worst": worst, "proxy": proxy, "same": same}


def phase_dnc_parity(card):
    """[dnc-parity]: d = 40, 8 disjoint groups of 5 attributes, all <=3-way
    inside each group.  compare_with_monolithic's ratio within 1e-9 of 1;
    the CompositeEngine and the MarginalEngine releases on the card each
    within 6 sigma of every exact marginal; the fused kernel launched."""
    from repro_torch.core import (CompositePlan, compare_with_monolithic,
                                  select)
    from repro_torch.data.tabular import mixture_marginals
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    wk = blocked_workload(40, 5, 3)
    t0 = time.perf_counter()
    rep = compare_with_monolithic(wk, 1.0)
    secs = {"compare": time.perf_counter() - t0}
    dnc = select(wk, 1.0, strategy="dnc")
    mono = select(wk, 1.0, strategy="monolithic")
    margs = mixture_marginals(wk.domain, mono.cliques, DNC_MASS, SEED)
    eng = dnc.engine(device="cuda")
    reset_chain_stats()
    t0 = time.perf_counter()
    tables, _ = eng.release(margs, cuda_gen())
    torch.cuda.synchronize()
    secs["composite release"] = time.perf_counter() - t0
    counts = chain_stats()
    rows = range(len(wk.cliques))
    worst_d = sigma_dev(dnc, tables, margs, rows)
    t0 = time.perf_counter()
    mtables, _ = MarginalEngine(mono, device="cuda").release(margs, cuda_gen())
    torch.cuda.synchronize()
    secs["monolithic release"] = time.perf_counter() - t0
    worst_m = sigma_dev(mono, mtables, margs, rows)
    print(f"[dnc-parity] d=40, {len(wk.cliques)} marginals, "
          f"{dnc.n_blocks} blocks, straddlers "
          f"{dnc.decomposition.n_straddlers}; compare_with_monolithic ratio "
          f"{rep['ratio']!r}, max rel marginal diff "
          f"{rep['max_rel_marginal_diff']:.3e}; worst table composite "
          f"{worst_d:.3f} sigma, monolithic {worst_m:.3f} sigma (bound 6); "
          f"seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; launches {counts} | {card}")
    if not (isinstance(dnc, CompositePlan) and abs(rep["ratio"] - 1) <= 1e-9
            and rep["exact_partition"] == 1.0):
        raise AssertionError(f"D&C left the monolithic optimum: {rep}")
    if not (worst_d <= 6.0 and worst_m <= 6.0 and counts["fused_launches"]):
        raise AssertionError("a d=40 release left 6 sigma or skipped the "
                             "fused kernel")
    return counts


def cells_of(index, sizes, rows):
    """(len(rows),) cells of each row's table (``index``: the clique list's
    ``width_index``)."""
    rows = np.asarray(rows, np.int64)
    out = np.ones(rows.size, np.int64)
    for rk, mat in rows_by_width(index, rows).values():
        out[np.isin(rows, rk)] = np.prod(sizes[mat], axis=1)
    return out


def nonneg_straddlers(tables, cliques, index, sizes, rows, total):
    """(negative cells, max |sum - total| / total) over the tables of
    ``rows``, in batches of one number of cells (``index``: the clique
    list's ``width_index``)."""
    from repro_torch.core.partition import group_rows
    neg, off = 0, 0.0
    for rk, mat in rows_by_width(index, rows).values():
        cells = np.prod(sizes[mat], axis=1)
        for grp in group_rows(cells[:, None]):
            for part in chunks(rk[grp], int(cells[grp[0]])):
                t = stacked(tables, cliques, part, int(cells[grp[0]]))
                neg += int((t < 0).sum())
                off = max(off, float(np.max(np.abs(t.sum(axis=1) - total)))
                          / total)
    return neg, off


def dnc_release(card, tag, plan, wk, secs):
    """The release of [dnc-d500] and [dnc-d200] on the card: mixture
    marginals of the plan's closure and the workload, ``plan.engine``, a
    release (in-block and 1-way tables within 6 sigma of the exact
    marginal, straddlers within 6 sigma of the product of their exact parts
    by ``straddler_dev``, their distance from the exact marginal printed in
    the proxy sigma; ``straddler_check``), a second release from one seed
    bit-identical, device ms by kernel of that second release, nonneg (no
    negative cell, in-block sums within 2 ulp of the pinned total,
    straddlers within rel 1e-9 of it) and
    synthesize(100,000) in range.  ``secs`` holds the seconds printed
    before the release's; returns the first release's launch counts and
    the host seconds of its stages."""
    from repro_torch.data.tabular import mixture_marginals
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    dom = wk.domain
    d = plan.decomposition
    t0 = time.perf_counter()
    exact = mixture_marginals(dom, list(dict.fromkeys(
        list(plan.cliques) + list(wk.cliques))), DNC_MASS, SEED)
    secs["marginals"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = plan.engine(device="cuda")
    secs["engine"] = time.perf_counter() - t0
    timed_engine(eng, secs)
    stages = {"block reconstruct": [], "straddler grouping": [],
              "assembly": []}       # host seconds of each call

    def timer(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[key].append(time.perf_counter() - t)
            return out
        return run
    eng._block_tables = timer("block reconstruct", eng._block_tables)
    eng._straddler_groups = timer("straddler grouping",
                                  eng._straddler_groups)
    eng._assemble = timer("assembly", eng._assemble)
    reset_chain_stats()
    t0 = time.perf_counter()
    tables, _ = eng.release(exact, cuda_gen())
    secs["release"] = time.perf_counter() - t0
    counts = chain_stats()
    secs = dict(secs)               # the first release's; later ones rewrite
    inb = np.flatnonzero(d.row_block >= 0)
    strad = np.flatnonzero(d.row_block < 0)
    # the second release under the profiler, in one session: a retake
    # would run the whole release again (the profiler drops a few of
    # d = 200's 11,458 launches in a busy process; ``profiled`` prints how
    # many it recorded)
    second = {}

    def release_again():
        second["tables"], _ = eng.release(exact, cuda_gen())
        second["end"] = time.perf_counter()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ms = kernel_ms(profiled(release_again, tries=1)[0])
    secs["second release"] = time.perf_counter() - t0
    post = {"profiler after": time.perf_counter() - second["end"]}
    again = second.pop("tables")
    t0 = time.perf_counter()
    index = width_index(wk.cliques)
    worst = sigma_dev(plan, tables, exact, inb, index)
    strads = straddler_check(plan, tables, exact, strad, device="cuda",
                             again=again, index=index)
    worst_t, worst_s = strads["worst"], strads["proxy"]
    same = (tables.keys() == again.keys() and strads["same"]
            and all(np.array_equal(tables[wk.cliques[r]],
                                   again[wk.cliques[r]]) for r in inb))
    secs["check"] = time.perf_counter() - t0
    del again
    sizes = np.asarray(dom.sizes, np.int64)
    cells = int(cells_of(index, sizes, inb).sum())
    s_cells = int(cells_of(index, sizes, strad).sum())
    print(f"[{tag}] release seconds (measure and reconstruct of the "
          f"first release): "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; straddler assembly on the host {stages['assembly'][0]:.3f} "
          f"(first release, its grouping built) and "
          f"{stages['assembly'][1]:.3f} (second); "
          f"worst in-block/1-way table {worst:.3f} sigma over {len(inb)} "
          f"tables, {cells} cells (bound 6; {cells + s_cells} cells in all "
          f"the workload's tables); worst straddler {worst_t:.3f} sigma of "
          f"the product of its exact parts over {len(strad)} tables, "
          f"{s_cells} cells (bound 6), {worst_s:.3f} proxy sigma from the "
          f"exact marginal (not gated); two releases from one seed "
          f"bit-identical {same}; launches {counts} | {card}")
    if not (worst <= 6.0 and worst_t <= 6.0 and same
            and counts["fused_launches"] > 0):
        raise AssertionError(f"the {tag} D&C release left 6 sigma, was not "
                             "reproducible or skipped the fused kernel")
    print(f"[{tag}] device ms of the second release by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
          + f" | {card}")
    del tables
    t0 = time.perf_counter()
    with ReleaseStages() as nonneg_stages:
        nn, meas = eng.release(exact, cuda_gen(), postprocess="nonneg")
    post["nonneg release"] = time.perf_counter() - t0
    total = float(np.asarray(meas[()].omega).reshape(-1)[0])
    neg = sum(int((nn[wk.cliques[r]] < 0).sum()) for r in inb)
    off_in = max(abs(float(np.sum(nn[wk.cliques[r]])) - total)
                 / np.spacing(total) for r in inb)
    neg_s, off_s = nonneg_straddlers(nn, wk.cliques, index, sizes, strad,
                                     total)
    neg += neg_s
    del nn
    t0 = time.perf_counter()
    recs = eng.synthesize(SYNTH_RECORDS, cuda_gen())
    post["synthesize"] = time.perf_counter() - t0
    ok_recs = (recs.shape == (SYNTH_RECORDS, dom.n_attrs) and recs.min() >= 0
               and bool(np.all(recs.max(axis=0) < sizes)))
    print(f"[{tag}] nonneg: negative cells {neg}, worst in-block |sum - "
          f"total| {off_in:.1f} ulp of the pinned total {total:.6f}, worst "
          f"straddler rel {off_s:.3e}; synthesize({SYNTH_RECORDS}) "
          f"{recs.shape} in range {ok_recs}; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in post.items()
                      if k != "profiler after")
          + f" | {card}")
    if neg or off_in > 2 or off_s > 1e-9 or not ok_recs:
        raise AssertionError(f"the {tag} nonneg release or its synthesis is "
                             "off")
    secs.update(post)
    secs["nonneg stages"] = nonneg_stages.line()
    secs["block reconstruct"] = stages["block reconstruct"][0]
    secs["straddler grouping"] = stages["straddler grouping"][0]
    secs["assembly"], secs["assembly second"] = stages["assembly"][:2]
    return counts, secs


def phase_dnc_d500(card, child):
    """[dnc-d500]: d = 500 all <=2-way, strategy="dnc" (SoV), released on
    the card over mixture marginals (``dnc_release``)."""
    from repro_torch.core import all_kway, select
    dom = mixed_domain(DNC_D)
    wk = all_kway(dom, 2, include_lower=True)
    secs = {}
    t0 = time.perf_counter()
    plan = select(wk, 1.0, strategy="dnc")
    secs["select_dnc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan.variances_array()
    secs["variances_array"] = time.perf_counter() - t0
    d = plan.decomposition
    print(f"[dnc-d500] d={DNC_D} all <=2-way: {len(wk.cliques)} marginals, "
          f"{plan.n_blocks} blocks, {d.n_straddlers} straddlers, composite "
          f"closure {len(plan.cliques)} cliques; seconds: select_dnc "
          f"{secs['select_dnc']:.3f}, variances_array "
          f"{secs['variances_array']:.3f} | {card}")
    print(f"[dnc-d500] the same select in a child process started with the "
          f"smoke: workload "
          f"{child['workload_s']:.3f} s, select {child['select_s']:.3f} s, "
          f"peak host RSS {child['peak_gib']:.3f} GiB (after the imports "
          f"{child['base_gib']:.3f} GiB) | {card}")
    return dnc_release(card, "dnc-d500", plan, wk, secs)[0]


def phase_dnc_d200(card, r):
    """[dnc-d200]: d = 200 all <=3-way.  select(strategy="auto") goes past
    AUTO_DNC_NNZ to a CompositePlan, first in a fresh child process started
    with the smoke (``plan_in_child``: seconds and peak RSS of the planner
    alone), then here, with the child's blocks and straddlers; released on
    the card as [dnc-d500] is (``dnc_release``).  Prints the straddlers and
    their cells by number of parts, seconds by stage, the peak host RSS of
    this process (the smoke runs the phase in a process of its own,
    ``background_start``) and its peak device memory."""
    import resource
    from repro_torch.core import CompositePlan, all_kway, select
    from repro_torch.core.select import AUTO_DNC_NNZ
    print(f"[dnc-d200] d={DNC_AUTO_D} all <=3-way (a child process "
          f"started with the smoke): "
          f"{r['marginals']} marginals, estimated incidence {r['est']} "
          f"(AUTO_DNC_NNZ {AUTO_DNC_NNZ}) -> CompositePlan {r['composite']}, "
          f"{r['blocks']} blocks, {r['straddlers']} straddlers; seconds: "
          f"workload {r['workload_s']:.3f}, select {r['select_s']:.3f}; peak "
          f"host RSS {r['peak_gib']:.3f} GiB (after the imports "
          f"{r['base_gib']:.3f} GiB) | {card}")
    if not (r["est"] > AUTO_DNC_NNZ and r["composite"]):
        raise AssertionError("strategy='auto' did not take the D&C route")
    torch.cuda.reset_peak_memory_stats()
    dom = mixed_domain(DNC_AUTO_D)
    secs = {}
    t0 = time.perf_counter()
    wk = all_kway(dom, 3, include_lower=True)
    plan = select(wk, 1.0, strategy="auto")
    secs["select_auto"] = time.perf_counter() - t0
    if not (isinstance(plan, CompositePlan) and plan.n_blocks == r["blocks"]
            and plan.decomposition.n_straddlers == r["straddlers"]):
        raise AssertionError("select(strategy='auto') in the phase differs "
                             "from the child's plan")
    d = plan.decomposition
    strad = np.flatnonzero(d.row_block < 0)
    n_parts = np.bincount(d.part_row, minlength=len(wk.cliques))[strad]
    cells = np.ones(len(wk.cliques), np.int64)  # a straddler's: its parts'
    np.multiply.at(cells, d.part_row, d.part_cells.astype(np.int64))
    cells = cells[strad]
    split = ", ".join(f"{k}-part {int((n_parts == k).sum())} tables "
                      f"{int(cells[n_parts == k].sum())} cells"
                      for k in np.unique(n_parts).tolist())
    print(f"[dnc-d200] select(strategy='auto') in the phase's process: "
          f"{len(wk.cliques)} marginals, {plan.n_blocks} blocks, "
          f"{d.n_straddlers} straddlers ({split}), composite closure "
          f"{len(plan.cliques)} cliques; seconds: workload and select_auto "
          f"{secs['select_auto']:.3f} | {card}")
    if not {2, 3} <= set(n_parts.tolist()):
        raise AssertionError(f"the d={DNC_AUTO_D} straddlers lack 2- or "
                             "3-part ones")
    counts, stages = dnc_release(card, "dnc-d200", plan, wk, secs)
    del plan, wk, d
    free_device_memory()
    keys = ("marginals", "engine", "measure", "block reconstruct",
            "straddler grouping", "assembly", "second release",
            "assembly second", "check", "nonneg release", "synthesize")
    print(f"[dnc-d200] seconds by stage: "
          + ", ".join(f"{k} {stages[k]:.3f}" for k in keys)
          + f" (measure and block reconstruct of the first release, the "
          f"second under the profiler, {stages['profiler after']:.3f} s of "
          f"it the profiler's own after the release; check: the gates); "
          f"nonneg's "
          f"release stages: "
          f"{stages['nonneg stages']}; peak host RSS of "
          f"the phase's process "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.3f}"
          f" GiB; peak device memory in the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{counts} | {card}")
    return counts


def phase_sharded_adult(card, adult, plan, records, synth2_plan,
                        synth2_records):
    """[sharded-adult]: sharded tables on the card (group=None and a
    one-rank NCCL group) equal the host tables; sharded_measure equals
    MarginalEngine.measure bit for bit, its second call a cache hit;
    corpus_marginal_release(postprocess="consistent") within 6 sigma; the
    secure sharded measure on [secure-synth2] equals DiscreteEngine.measure
    bit for bit."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core.accountant import PrivacyBudget
    from repro_torch.data.tabular import marginals_from_records
    from repro_torch.engine import (DiscreteEngine, MarginalEngine,
                                    corpus_marginal_release,
                                    sharded_marginals, sharded_measure)
    from repro_torch.engine.sharded import _ENGINE_CACHE
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    secs = {}
    host = marginals_from_records(adult, plan.cliques, records)
    # The references the equalities compare against run outside the
    # launch windows: a window holds the sharded path's own launches only.
    m2 = MarginalEngine(plan, device="cuda").measure(host, cuda_gen())
    s2 = DiscreteEngine(synth2_plan, device="cuda").measure(
        marginals_from_records(synth2_plan.domain, synth2_plan.cliques,
                               synth2_records), cuda_gen())
    t0 = time.perf_counter()
    tabs = sharded_marginals(adult, plan.cliques, records, device="cuda")
    secs["sharded_marginals"] = time.perf_counter() - t0
    eq_local = same_family(tabs, host)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.makedirs("build", exist_ok=True)
    store = os.path.join("build", f"nccl_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        t0 = time.perf_counter()
        tabs_g = sharded_marginals(adult, plan.cliques, records,
                                   group=dist.group.WORLD, device="cuda")
        secs["sharded_marginals nccl"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):      # the store removes it when done
            os.remove(store)
    eq_group = same_family(tabs_g, host)
    # Window 1: the sharded measures (plain twice, then secure).
    reset_chain_stats()
    t0 = time.perf_counter()
    m1 = sharded_measure(plan, records, cuda_gen(), device="cuda")
    secs["sharded_measure"] = time.perf_counter() - t0
    hits = _ENGINE_CACHE.hits
    t0 = time.perf_counter()
    sharded_measure(plan, records, cuda_gen(), device="cuda")
    secs["sharded_measure again"] = time.perf_counter() - t0
    hit = _ENGINE_CACHE.hits == hits + 1
    t0 = time.perf_counter()
    s1 = sharded_measure(synth2_plan, synth2_records, cuda_gen(),
                         secure=True, device="cuda")
    secs["secure sharded_measure"] = time.perf_counter() - t0
    measure_counts = chain_stats()
    eq_meas = all(np.array_equal(m1[c].omega, m2[c].omega)
                  for c in plan.cliques)
    eq_secure = all(np.array_equal(s1[c].omega, s2[c].omega)
                    for c in synth2_plan.cliques)
    # Window 2: the corpus release.
    budget = PrivacyBudget.from_zcdp(1.0)
    reset_chain_stats()
    t0 = time.perf_counter()
    tables, var, report = corpus_marginal_release(
        adult, plan.workload, records, budget, 1.0, cuda_gen(),
        postprocess="consistent", device="cuda")
    secs["corpus consistent"] = time.perf_counter() - t0
    corpus_counts = chain_stats()
    worst = max(float(np.abs(tables[c] - host[c]).max() / math.sqrt(var[c]))
                for c in plan.workload.cliques)
    print(f"[sharded-adult] {len(plan.cliques)} closure tables over "
          f"{len(records)} records: sharded == host tables {eq_local}, under "
          f"a one-rank NCCL group {eq_group}; sharded_measure == "
          f"MarginalEngine.measure bit for bit {eq_meas}; second call a "
          f"cache hit {hit}; corpus consistent worst table {worst:.3f} sigma "
          f"(bound 6), budget report {report}; secure sharded_measure on "
          f"Synth-10^{SYNTH_D} <=2-way ({len(synth2_records)} records) == "
          f"DiscreteEngine.measure bit for bit {eq_secure}; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; launches of the sharded measures {measure_counts}, of the "
          f"corpus release {corpus_counts} | {card}")
    if not (eq_local and eq_group and eq_meas and hit and worst <= 6.0
            and eq_secure):
        raise AssertionError("sharded measurement differs from the direct "
                             "path")
    for what, c in (("sharded measures", measure_counts),
                     ("corpus release", corpus_counts)):
        if not c["fused_launches"] + c["axis_launches"]:
            raise AssertionError(f"the {what} launched no kernel: {c}")
    return {f: measure_counts[f] + corpus_counts[f] for f in measure_counts}


def phase_obs(card, plan, margs):
    """[obs]: one Adult release traced to a JSONL file under build/: the
    span tree holds engine.measure and engine.reconstruct with kernel.chain
    children, the tables are the untraced ones bit for bit, and /metrics
    holds the four shared families and the roofline gauges."""
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    from repro_torch.obs import REGISTRY, TRACER, parse_exposition
    eng = MarginalEngine(plan, device="cuda")
    eng.release(margs, cuda_gen())
    secs = {"off": [], "on": []}
    path = os.path.join("build", "obs_trace.jsonl")
    reset_chain_stats()
    for rnd in range(OBS_ROUNDS):
        for label in ("off", "on") if rnd % 2 == 0 else ("on", "off"):
            if label == "on":
                if os.path.exists(path):
                    os.remove(path)
                TRACER.enable(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tables, _ = eng.release(margs, cuda_gen())
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
            if label == "on":
                TRACER.disable()
                traced = tables
                with open(path) as fh:
                    spans = [json.loads(ln) for ln in fh]
                os.remove(path)
            else:
                plain = tables
    counts = chain_stats()
    by_id = {s["span"]: s for s in spans}
    names = {}
    for s in spans:
        names[s["name"]] = names.get(s["name"], 0) + 1
    parents = {}
    for s in spans:
        if s["name"] == "kernel.chain" and s["parent"] in by_id:
            p = by_id[s["parent"]]["name"]
            parents[p] = parents.get(p, 0) + 1
    same = same_family(plain, traced)
    fams = ("repro_engine_events_total", "repro_kernel_events_total",
            "repro_engine_cache_events_total", "repro_kernel_launch_seconds",
            "repro_chain_predicted_intensity", "repro_chain_smem_bytes",
            "repro_chain_predicted_seconds")
    text = REGISTRY.exposition()
    parse_exposition(text)
    missing = [f for f in fams if f"# TYPE {f} " not in text]
    med = {k: float(np.median(v)) for k, v in secs.items()}
    print(f"[obs] Adult release seconds, {OBS_ROUNDS} rounds alternated: "
          f"tracing off median {med['off']:.3f} {[round(v, 3) for v in secs['off']]}, "
          f"on median {med['on']:.3f} {[round(v, 3) for v in secs['on']]}; spans by "
          f"name {names}; kernel.chain spans by parent {parents}; traced == "
          f"untraced tables bit for bit {same}; /metrics {len(text)} bytes, "
          f"families missing {missing} | {card}")
    if not (same and not missing
            and parents.get("engine.measure", 0) > 0
            and parents.get("engine.reconstruct", 0) > 0):
        raise AssertionError("the traced release or /metrics is incomplete")
    return counts


def phase_rplus_maxvar(card):
    """[rplus-maxvar]: select_plus(..., "max_variance") on the card twice
    (sigma bit-identical) and on the CPU route (loss within rel 5e-3: the
    reference's own iterates wander by about +-0.2% of the loss), the
    setting of tests/test_torch_plus.py (d = 2 range, lr 0.01, 3000
    steps)."""
    from repro_torch.core import Domain, all_kway
    from repro_torch.core.plus import PlusSchema, select_plus
    sizes, kinds = [4, 4], ["range", "range"]
    wk = all_kway(Domain.create(sizes), 2, include_lower=True)

    def run(dev):
        schema = PlusSchema.create(Domain.create(sizes), kinds,
                                   strategy_mode="hier", device=dev)
        t0 = time.perf_counter()
        p = select_plus(wk, schema, 1.0, "max_variance", steps=3000, lr=0.01,
                        device=dev)
        return p, time.perf_counter() - t0

    (a, ta), (b, tb), (c, tc) = run("cuda"), run("cuda"), run("cpu")
    same = bool(np.array_equal(a.sigma, b.sigma)
                and a.loss_value == b.loss_value)
    rel = abs(a.loss_value - c.loss_value) / c.loss_value
    print(f"[rplus-maxvar] loss card {a.loss_value!r}, CPU {c.loss_value!r} "
          f"(rel {rel:.3e}, bound 5e-3); two card calls bit-identical {same}; "
          f"seconds card {ta:.3f} / {tb:.3f}, CPU {tc:.3f} | {card}")
    if not (same and rel <= 5e-3):
        raise AssertionError("RP+ max-variance on the card is not "
                             "reproducible or left the CPU route")


SERVE_TENANTS = 8      # [serve-adult]: tenants, each its own plan and rho
SERVE_PER_TENANT = 2   # requests a tenant in the batched drain
# 16 Adult releases hold 3.4e8 cells: at 6 sigma about 0.7 cells would
# exceed the bound by chance (this phase's seeds read 6.49 on an NVIDIA
# H100), at 7 sigma 9e-4 -- [synth]'s reason for 7 sigma over 1.6e8 cells.
SERVE_K_SIGMA = 7.0


def http_get(url):
    """(status, body) of a GET on the smoke's own stats server."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def prefilled_drain(srv, requests):
    """Prefill a paused server with ``requests``, resume it and wait for
    every result: (results, wall seconds from resume to the last one)."""
    srv.pause()
    futs = [srv.submit(r) for r in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.resume()
    res = [f.result(900) for f in futs]
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_serve_adult(card, adult):
    """[serve-adult]: the release server at a service's size.  8 tenants,
    each its own Adult <=3-way plan, rho and 48,842 seeded records, built by
    repro_torch.launch.serve.build_server; 16 requests (2 a tenant, explicit
    seeds) prefilled on a paused server with max_batch=16 and drained as one
    batch, inside one launch window.  Gates: every result batched in a batch
    of 16; the fused measure's chain calls equal those of one request's
    measure; batched_launch_groups equal the plan's signature count; both
    kernels launched; every measurement equal to measure() on its seed and
    every table to engine.reconstruct of it, bit for bit; every table within
    7 sigma (SERVE_K_SIGMA); the same requests at max_batch=1 bit-identical; a small-rho
    tenant refused with its exact remaining budget; nonneg then synthesis
    charging nothing; an RP+ range tenant and a secure tenant on the solo
    path within their sigma; the ledger replayed to the same spend;
    /healthz 200, /metrics agreeing with /stats, /stats holding kernels
    and autotune."""
    from repro_torch.core import all_kway, select_sum_of_variances
    from repro_torch.core.accountant import BudgetExhausted
    from repro_torch.core.mechanism import (measure, pcost_of_plan,
                                            signature_groups)
    from repro_torch.core.plus import PlusSchema, select_plus
    from repro_torch.core.domain import Domain
    from repro_torch.data.tabular import (marginals_from_records,
                                          synthetic_records)
    from repro_torch.engine import multi as multi_mod
    from repro_torch.engine import sharded_marginals
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    from repro_torch.launch.serve import build_server
    from repro_torch.obs import parse_exposition
    from repro_torch.serve import (BudgetLedger, ReleaseRequest,
                                   ReleaseServer, start_stats_http)
    secs = {}
    os.makedirs("build", exist_ok=True)
    paths = [os.path.join("build", f"serve_{name}_{os.getpid()}.jsonl")
             for name in ("ledger", "ledger_seq")]
    for path in paths:
        if os.path.exists(path):
            os.remove(path)
    # Each tenant's own rho: the drains below, and the profiler's retakes.
    rhos = [10.0 + t for t in range(SERVE_TENANTS)]
    t0 = time.perf_counter()
    srv = build_server(paths[0], n_tenants=SERVE_TENANTS, rho=rhos,
                       max_batch=SERVE_TENANTS * SERVE_PER_TENANT, kway=3,
                       device="cuda")
    secs["build_server"] = time.perf_counter() - t0
    httpd = None
    try:
        tenants = srv.tenants()
        plans = {t: srv._sessions[t].plan for t in tenants}
        plan0 = plans[tenants[0]]
        t0 = time.perf_counter()
        margs = {t: sharded_marginals(adult, plans[t].cliques,
                                      synthetic_records(adult, ADULT_RECORDS,
                                                        i), device="cuda")
                 for i, t in enumerate(tenants)}
        secs["marginals"] = time.perf_counter() - t0
        requests = [ReleaseRequest(tenant=t, marginals=margs[t],
                                   seed=1000 + SERVE_PER_TENANT * i + r)
                    for i, t in enumerate(tenants)
                    for r in range(SERVE_PER_TENANT)]
        n_req = len(requests)
        # One request's measure, outside the window: its chain calls.
        st0 = chain_stats()
        measure(plan0, margs[tenants[0]], cuda_gen(1000), device="cuda")
        st1 = chain_stats()
        solo_calls = sum(st1[k] - st0[k]
                         for k in ("fused_chains", "fallback_chains"))
        groups = len(signature_groups(adult, plan0.cliques))
        # The window: one batched drain of all requests.  The fused measure's
        # chain calls are counted at measure_multi's chain entry.
        calls = [0]
        real = multi_mod.fused_chain_matvec

        def counting(*a, **k):
            calls[0] += 1
            return real(*a, **k)

        multi_mod.fused_chain_matvec = counting
        try:
            groups_before = srv.stats.batched_launch_groups
            reset_chain_stats()
            batched, secs["batched drain"] = prefilled_drain(srv, requests)
            counts = chain_stats()
        finally:
            multi_mod.fused_chain_matvec = real
        drain_groups = srv.stats.batched_launch_groups - groups_before
        lat = {t: srv.stats.tenant(t).to_dict() for t in tenants}
        all_batched = all(r.batched and r.batch_size == n_req
                          for r in batched)
        # Every result against measure() on its seed and reconstruct of it.
        t0 = time.perf_counter()
        eq_meas = eq_tab = True
        worsts = []
        for r, req in zip(batched, requests):
            plan = plans[req.tenant]
            eng = srv.pool.engine_for(req.tenant, plan, device="cuda")
            direct = measure(plan, req.marginals, cuda_gen(req.seed),
                             device="cuda")
            eq_meas &= all(np.array_equal(r.measurements[c].omega,
                                          direct[c].omega)
                           for c in plan.cliques)
            again = eng.reconstruct(direct)
            eq_tab &= all(np.array_equal(r.tables[c], again[c])
                          for c in plan.workload.cliques)
            worsts.append(check_tables(plan, r.tables, req.marginals,
                                       SERVE_K_SIGMA))
        secs["checks"] = time.perf_counter() - t0
        # The same requests, one at a time (max_batch=1, the same pool).
        seq_srv = ReleaseServer(BudgetLedger(paths[1]), max_batch=1,
                                pool=srv.pool, device="cuda").start()
        try:
            for t in tenants:
                seq_srv.register_tenant(t, plans[t], rho=rhos[0])
            seq, secs["sequential drain"] = prefilled_drain(seq_srv, requests)
            seq_lat = {t: seq_srv.stats.tenant(t).to_dict() for t in tenants}
        finally:
            seq_srv.stop()
            seq_srv.ledger.close()
        eq_seq = (not any(r.batched for r in seq)) and all(
            all(np.array_equal(a.tables[c], b.tables[c]) for c in a.tables)
            for a, b in zip(batched, seq))
        del seq
        # Device ms of one more batched drain, by kernel.
        ms = kernel_ms_by_name(lambda: prefilled_drain(srv, requests))
        # A tenant whose rho admits 1.5 releases: the second is refused with
        # the exact remaining budget, and nothing is charged for it.
        per = pcost_of_plan(plan0)
        srv.register_tenant("tenant-poor", plan0, pcost=1.5 * per)
        srv.request_sync(ReleaseRequest(tenant="tenant-poor",
                                        marginals=margs[tenants[0]], seed=1),
                         timeout=600)
        spent = srv.ledger.spent("tenant-poor")
        try:
            srv.request_sync(ReleaseRequest(tenant="tenant-poor",
                                            marginals=margs[tenants[0]]),
                             timeout=600)
            refused = None
        except BudgetExhausted as exc:
            refused = exc
        refusal_ok = (refused is not None
                      and refused.remaining_pcost
                      == srv.ledger.remaining("tenant-poor")
                      and abs(refused.remaining_pcost - 0.5 * per) <= 1e-9
                      and srv.ledger.spent("tenant-poor") == spent)
        # Solo paths: a small plain tenant (nonneg, then synthesis), an RP+
        # range tenant and a secure tenant.
        small = Domain.create([5, 5, 5])
        sp = select_sum_of_variances(all_kway(small, 2, include_lower=True),
                                     1.0)
        sm = marginals_from_records(small, sp.cliques,
                                    synthetic_records(small, 2000, seed=3))
        srv.register_tenant("tenant-small", sp, rho=10.0)
        nn = srv.request_sync(ReleaseRequest(tenant="tenant-small",
                                             marginals=sm, seed=5,
                                             postprocess="nonneg"))
        spent_small = srv.ledger.spent("tenant-small")
        syn = srv.request_sync(ReleaseRequest(tenant="tenant-small",
                                              kind="synthesis",
                                              n_records=10000, seed=6))
        synth_ok = (all(float(t.min()) >= 0 for t in nn.tables.values())
                    and syn.records.shape == (10000, small.n_attrs)
                    and syn.pcost_charged == 0.0
                    and srv.ledger.spent("tenant-small") == spent_small)
        rdom = Domain.create([16, 8, 6],
                             kinds=["numeric", "numeric", "categorical"])
        schema = PlusSchema.create(rdom, ["range", "prefix", "identity"],
                                   strategy_mode="hier", device="cuda")
        rp = select_plus(all_kway(rdom, 2, include_lower=True), schema, 1.0,
                         device="cuda")
        rm = marginals_from_records(rdom, rp.cliques,
                                    synthetic_records(rdom, 5000, seed=4))
        srv.register_tenant("tenant-range", rp, rho=10.0)
        rr = srv.request_sync(ReleaseRequest(tenant="tenant-range",
                                             kind="range", marginals=rm,
                                             seed=7))
        worst_range = check_plus_tables(rp, rr.tables, rm, 6.0)
        srv.register_tenant("tenant-secure", sp, rho=10.0, secure=True)
        sr = srv.request_sync(ReleaseRequest(tenant="tenant-secure",
                                             marginals=sm, seed=8))
        seng = srv.pool.engine_for("tenant-secure", sp, secure=True,
                                   device="cuda")
        worst_secure = check_tables(sigma_bar_plan(sp, seng), sr.tables, sm,
                                    6.0)
        solo_ok = not (nn.batched or rr.batched or sr.batched)
        # Replay, HTTP.
        replay = BudgetLedger(paths[0])
        replay_ok = all(replay.spent(t) == srv.ledger.spent(t)
                        for t in srv.ledger.tenants) \
            and set(replay.tenants) == set(srv.ledger.tenants)
        replay.close()
        httpd, port = start_stats_http(srv)
        base = f"http://127.0.0.1:{port}"
        health, _ = http_get(f"{base}/healthz")
        _, body = http_get(f"{base}/metrics")
        parsed = parse_exposition(body)
        _, body = http_get(f"{base}/stats")
        stats = json.loads(body)
        req_total = parsed["repro_serve_requests_total"]
        http_ok = (health == 200 and "kernels" in stats
                   and "autotune" in stats
                   and parsed["repro_serve_batches_total"][""]
                   == stats["batches"]
                   and all(req_total.get(f'tenant="{t}",outcome="completed"',
                                         0) == s["completed"]
                           for t, s in stats["tenants"].items())
                   and all(parsed["repro_ledger_charges_total"][
                       f'tenant="{t}"'] == led["charges"]
                           and parsed["repro_ledger_pcost_spent"][
                       f'tenant="{t}"'] == led["pcost_spent"]
                           for t, led in stats["ledger"].items()))
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
        srv.ledger.close()
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
    bw, sw = secs["batched drain"], secs["sequential drain"]
    pct = {k: (float(np.median([v[t][k] for t in tenants])),
               max(v[t][k] for t in tenants))
           for v in (lat,) for k in ("p50_ms", "p99_ms")}
    seq_pct = {k: (float(np.median([seq_lat[t][k] for t in tenants])),
                   max(seq_lat[t][k] for t in tenants))
               for k in ("p50_ms", "p99_ms")}
    print(f"[serve-adult] {SERVE_TENANTS} tenants x {SERVE_PER_TENANT} "
          f"requests, Adult <=3-way ({len(plan0.cliques)} closure cliques, "
          f"{sum(adult.n_cells(c) for c in plan0.cliques)} cells a release): "
          f"batched drain {bw:.3f} s ({n_req / bw:.2f} requests/s), "
          f"sequential (max_batch=1) {sw:.3f} s ({n_req / sw:.2f} "
          f"requests/s), {sw / bw:.2f}x; latency ms (median of the tenants' "
          f"p50, largest p99) batched {pct['p50_ms'][0]:.1f} / "
          f"{pct['p99_ms'][1]:.1f}, sequential {seq_pct['p50_ms'][0]:.1f} / "
          f"{seq_pct['p99_ms'][1]:.1f} | {card}")
    print(f"[serve-adult] all batched in one batch of {n_req} {all_batched}; "
          f"fused measure chain calls {calls[0]} (one request's measure "
          f"{solo_calls}); batched_launch_groups {drain_groups} (signatures "
          f"{groups}); measurements == measure() bit for bit {eq_meas}; "
          f"tables == reconstruct bit for bit {eq_tab}; == max_batch=1 "
          f"{eq_seq}; worst table {max(worsts):.3f} sigma (bound "
          f"{SERVE_K_SIGMA}; releases past 6 sigma "
          f"{sum(w > 6.0 for w in worsts)} of {n_req}); refusal with "
          f"the exact remaining pcost {refusal_ok} "
          f"({refused.remaining_pcost if refused else None!r}); nonneg then "
          f"synthesis charges nothing {synth_ok}; solo RP+ range "
          f"{worst_range:.3f} sigma, secure {worst_secure:.3f} sigma-bar "
          f"(bound 6), solo {solo_ok}; ledger replay {replay_ok}; HTTP "
          f"(healthz {health}, /metrics == /stats) {http_ok}")
    print(f"[serve-adult] seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + "; device ms of one more batched drain by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
          + f"; launches {counts}")
    if not (all_batched and calls[0] == solo_calls and drain_groups == groups
            and eq_meas and eq_tab and eq_seq and refusal_ok and synth_ok
            and solo_ok and replay_ok and http_ok):
        raise AssertionError("[serve-adult] a gate failed (see above)")
    if not (counts["fused_launches"] > 0 and counts["axis_launches"] > 0):
        raise AssertionError(f"the batched drain skipped a kernel: {counts}")
    return counts


def phase_serve_cli(card):
    """[serve-cli]: ``python -m repro_torch.launch.serve --once`` in a child
    process (2 Adult <=2-way tenants, 2 requests each) exits 0 and prints
    its summary."""
    os.makedirs("build", exist_ok=True)
    ledger = os.path.join("build", f"serve_cli_{os.getpid()}.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--once",
         "--tenants", "2", "--requests", "2", "--port", "0", "--ledger",
         ledger], capture_output=True, text=True, timeout=600, env=env,
        cwd=root)
    wall = time.perf_counter() - t0
    if os.path.exists(ledger):
        os.remove(ledger)
    summary = [ln for ln in out.stdout.splitlines()
               if ln.startswith("[serve] demo traffic:")]
    print(f"[serve-cli] exit {out.returncode} in {wall:.1f} s: "
          f"{summary[0] if summary else 'no summary'} | {card}")
    if out.returncode != 0 or not summary:
        raise AssertionError(f"launch.serve failed:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    if "registered on cuda" not in out.stdout:
        raise AssertionError("launch.serve did not serve on the card")


HDMM_SYNTH_D = (2, 6, 8)   # [hdmm-synth]: Synth-10^d whose universe HDMM holds
HDMM_WALL_D = 10           # ... and the first it refuses (paper Table 3)
HDMM_CHI2_D = 8            # the d of the chi-square band and the profile
# [hdmm-prefix]: the paper's Table 8 RP+ RMSE (<=3-way prefix, pcost 1) and
# its numeric attributes (benchmarks/table6_9_rplus.py:20-24)
PAPER8 = {"adult": 48.903, "cps": 8.392, "loans": 36.651}
PREFIX_ATTRS = {"adult": (0, 1, 2, 3, 4), "cps": (0, 1), "loans": (0, 1, 2, 3)}


def hdmm_variances(union, budget=1.0):
    """sigma^2 of every HDMM answer, by sub-strategy: the Kronecker product
    of the per-axis diag(W_i (A_i^T A_i)^+ W_i^T), over share * budget."""
    out = []
    for sub, share in zip(union.subs, union.shares):
        v = np.ones(1)
        for W, A in zip(sub.factors_W, sub.factors_A):
            v = np.kron(v, np.diag(W @ np.linalg.pinv(A.T @ A) @ W.T))
        out.append(v / (share * budget))
    return out


def universe_vector(domain, records):
    """The universe vector of ``records`` on the card: one torch.bincount of
    their flat cell indices (row-major, as the Kronecker chains read it)."""
    rec = torch.as_tensor(records, device="cuda").long()
    flat = torch.zeros(rec.shape[0], dtype=torch.long, device="cuda")
    for i, n in enumerate(domain.sizes):
        flat = flat * n + rec[:, i]
    return torch.bincount(flat, minlength=domain.universe_size()).float()


def hdmm_release(union, domain, x, exact, k_sigma=6.0):
    """One hdmm_measure_reconstruct on the card (its launches counted from
    0), every answer finite, of its shape and within k_sigma of ``exact``
    (float64, by sub-strategy).  Returns (counts, facts): seconds, peak
    device memory above what was held before, the worst answer in sigma,
    the squared errors' sum, its expectation and variance, answers."""
    from repro_torch.baselines.hdmm import hdmm_measure_reconstruct
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_chain_stats()
    t0 = time.perf_counter()
    answers = hdmm_measure_reconstruct(union, domain, x, cuda_gen(), 1.0,
                                       device="cuda")
    torch.cuda.synchronize()
    facts = {"secs": time.perf_counter() - t0,
             "peak": torch.cuda.max_memory_allocated() - held,
             "held": held}
    counts = chain_stats()
    worst = sq = ev = var2 = 0.0
    n = 0
    for ans, var, want in zip(answers, hdmm_variances(union), exact):
        got = ans.double().cpu().numpy()
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"an HDMM answer has shape {got.shape} (want "
                                 f"{want.shape}) or non-finite values")
        err = got - want
        worst = max(worst, float(np.max(np.abs(err) / np.sqrt(var))))
        sq += float(err @ err)
        ev += float(var.sum())
        var2 += float(var @ var)
        n += err.size
    facts.update(worst=worst, sq=sq, ev=ev, var2=var2, n=n)
    if len(answers) != len(exact) or not worst <= k_sigma:
        raise AssertionError(f"an HDMM answer is {worst:.2f} sigma from its "
                             f"exact value (bound {k_sigma})")
    return counts, facts


def expect_hdmm_wall(union, domain, label):
    """hdmm_measure_reconstruct raises MemoryError at the guard and leaves
    the card's allocations as they were (nothing allocated, not even for a
    moment)."""
    from repro_torch.baselines.hdmm import hdmm_measure_reconstruct
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        hdmm_measure_reconstruct(union, domain, np.zeros(1), cuda_gen(), 1.0,
                                 device="cuda")
    except MemoryError as exc:
        msg = str(exc)
    else:
        raise AssertionError(f"{label}: HDMM did not refuse a "
                             f"{domain.universe_size():.3g}-cell universe")
    torch.cuda.synchronize()
    if not (torch.cuda.memory_allocated() == held
            and torch.cuda.max_memory_allocated() == held):
        raise AssertionError(f"{label}: the refusal allocated on the card")
    return msg


def phase_hdmm_synth(card):
    """[hdmm-synth] (paper Tables 2-4): Synth-10^d, all <=3-way, d in
    HDMM_SYNTH_D.  hdmm_marginals (host seconds), then
    hdmm_measure_reconstruct on the universe vector of 48,842 seeded
    records (built on the card with torch.bincount): every answer within
    6 sigma; at d = HDMM_CHI2_D the squared errors' sum within 5 sigma of
    its chi-square expectation, and the device ms by kernel.  Beside it RP
    (select_sum_of_variances with the RMSE-optimal cell weights ->
    MarginalEngine.release, 6 sigma) on the same workload and records:
    HDMM's analytic RMSE >= RP's * 0.999 and the SVD bound equal to RP's
    RMSE within 1e-9 (Table 4).  d = HDMM_WALL_D raises MemoryError and
    allocates nothing on the card (Table 3's wall).  HDMM's chains: the
    fused kernel at d = 2, the per-axis kernel beyond."""
    from repro_torch.baselines import hdmm_marginals
    from repro_torch.baselines.hdmm import hdmm_measure_reconstruct
    from repro_torch.baselines.svdb import svdb_rmse_marginals
    from repro_torch.core import all_kway, select_sum_of_variances
    from repro_torch.data.tabular import (marginals_from_records,
                                          synth_domain, synthetic_records)
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.kron_matvec.fused import plan_chain
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    counts = []
    for d in HDMM_SYNTH_D + (HDMM_WALL_D,):
        dom = synth_domain(10, d)
        wk = all_kway(dom, min(3, d), include_lower=True)
        t0 = time.perf_counter()
        union = hdmm_marginals(wk)
        t_sel = time.perf_counter() - t0
        if d == HDMM_WALL_D:
            msg = expect_hdmm_wall(union, dom, f"Synth-10^{d}")
            print(f"[hdmm-synth] d={d}: hdmm_marginals {t_sel:.3f} s (host); "
                  f"measure+reconstruct refused: MemoryError({msg!r}), "
                  f"nothing allocated on the card")
            continue
        records = synthetic_records(dom, ADULT_RECORDS, SEED)
        t0 = time.perf_counter()
        x = universe_vector(dom, records)
        torch.cuda.synchronize()
        t_x = time.perf_counter() - t0
        exact = marginals_from_records(dom, wk.cliques, records)
        hd_counts, hd = hdmm_release(union, dom, x,
                                     [exact[c] for c in wk.cliques])
        # the fused kernel while a universe-sized row fits a block
        route = "fused" if plan_chain(union.subs[0].factors_A,
                                      dom.sizes).fused_ok else "axis"
        on, off = (("fused_launches", "axis_launches") if route == "fused"
                   else ("axis_launches", "fused_launches"))
        if not (hd_counts[on] > 0 and hd_counts[off] == 0):
            raise AssertionError(f"d={d}: HDMM's chains did not take the "
                                 f"{route} route: {hd_counts}")
        t0 = time.perf_counter()
        plan = select_sum_of_variances(
            wk, 1.0, {c: float(dom.n_cells(c)) for c in wk.cliques})
        t_rp_sel = time.perf_counter() - t0
        margs = marginals_from_records(dom, plan.cliques, records)
        reset_chain_stats()
        t0 = time.perf_counter()
        tables, _ = MarginalEngine(plan, device="cuda").release(margs,
                                                                cuda_gen())
        torch.cuda.synchronize()
        t_rp = time.perf_counter() - t0
        rp_counts = chain_stats()
        rp_worst = check_tables(plan, tables, margs, 6.0)
        rp_sq = sum(float(((tables[c] - margs[c]) ** 2).sum())
                    for c in wk.cliques)
        hd_rmse, rp_rmse = union.rmse(1.0), plan.rmse()
        svdb = svdb_rmse_marginals(wk)
        print(f"[hdmm-synth] d={d}: {len(wk.cliques)} marginals, {hd['n']} "
              f"answers; HDMM select {t_sel:.3f} s (host), universe vector "
              f"{t_x:.3f} s, measure+reconstruct {hd['secs']:.3f} s, peak "
              f"device memory {hd['peak'] / 2**30:.3f} GiB above the "
              f"{hd['held'] / 2**30:.3f} GiB held (x among it); RP select "
              f"{t_rp_sel:.3f} s, release {t_rp:.3f} s | {card}")
        print(f"[hdmm-synth] d={d}: RMSE analytic HDMM {hd_rmse:.6f}, RP "
              f"{rp_rmse:.6f}, SVD bound {svdb:.6f}; empirical HDMM "
              f"{math.sqrt(hd['sq'] / hd['n']):.6f}, RP "
              f"{math.sqrt(rp_sq / hd['n']):.6f}; worst HDMM {hd['worst']:.3f}"
              f" sigma, RP {rp_worst:.3f} sigma; launches HDMM {hd_counts}")
        if d == HDMM_CHI2_D:
            band = 5 * math.sqrt(2 * hd["var2"])
            print(f"[hdmm-synth] d={d}: squared errors {hd['sq']:.1f}, "
                  f"expected {hd['ev']:.1f} +- {band:.1f} (5 sigma)")
            if not abs(hd["sq"] - hd["ev"]) <= band:
                raise AssertionError("HDMM's squared errors leave their "
                                     "chi-square band")
            ms = kernel_ms_by_name(lambda: hdmm_measure_reconstruct(
                union, dom, x, cuda_gen(), 1.0, device="cuda"))
            print(f"[hdmm-synth] d={d}: device ms of one more measure+"
                  f"reconstruct by kernel: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(ms.items())))
        if not hd_rmse >= rp_rmse * 0.999:
            raise AssertionError(f"d={d}: HDMM's RMSE {hd_rmse} beats RP's "
                                 f"{rp_rmse} on marginals")
        if not abs(svdb - rp_rmse) <= 1e-9:
            raise AssertionError(f"d={d}: RP's RMSE {rp_rmse} is not the SVD "
                                 f"bound {svdb}")
        counts += [hd_counts, rp_counts]
    return counts


def phase_hdmm_prefix(card):
    """[hdmm-prefix] (paper Tables 8-9): CPS, Adult and Loans, all <=3-way,
    the numeric attributes prefix queries, the rest identity.  For each:
    select_plus(..., "sov") RMSE (p-Identity strategies on the card),
    hdmm_generalized's RMSE and max variance, the seconds of each, and the
    paper's RP+ RMSE.  CPS's 280,000-cell universe is under HDMM's guard:
    PlusEngine.release and hdmm_measure_reconstruct (per-axis kernel) on
    48,842 seeded records, every answer of both within 6 sigma, and their
    empirical RMSEs.  Adult and Loans raise MemoryError at the guard."""
    from repro_torch.baselines import hdmm_generalized
    from repro_torch.baselines.hdmm import OOM_GUARD_ELEMS
    from repro_torch.core import all_kway
    from repro_torch.core.kron import kron_matvec_np
    from repro_torch.core.plus import PlusSchema, select_plus
    from repro_torch.data.tabular import (adult_domain, cps_domain,
                                          loans_domain, marginals_from_records,
                                          synthetic_records)
    from repro_torch.engine.plus_engine import PlusEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    counts = []
    for name, dom in (("cps", cps_domain()), ("adult", adult_domain()),
                      ("loans", loans_domain())):
        kinds = ["prefix" if i in PREFIX_ATTRS[name] else "identity"
                 for i in range(dom.n_attrs)]
        wk = all_kway(dom, 3, include_lower=True)
        t0 = time.perf_counter()
        schema = PlusSchema.create(dom, kinds, strategy_mode="auto",
                                   device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plan = select_plus(wk, schema, 1.0, "sov", device="cuda")
        t2 = time.perf_counter()
        union = hdmm_generalized(wk, kinds, device="cuda")
        t3 = time.perf_counter()
        print(f"[hdmm-prefix] {name}: RP+ (sov) RMSE {plan.rmse():.3f} "
              f"(paper {PAPER8[name]}), HDMM RMSE {union.rmse(1.0):.3f}, "
              f"HDMM max variance {union.max_variance(1.0):.3f}; seconds: "
              f"RP+ schema {t1 - t0:.3f}, RP+ select {t2 - t1:.3f}, HDMM "
              f"select {t3 - t2:.3f} ({len(union.subs)} sub-strategies x "
              f"{dom.n_attrs} axes on the host, p-Identity on the card)")
        if dom.universe_size() > OOM_GUARD_ELEMS:
            msg = expect_hdmm_wall(union, dom, name)
            print(f"[hdmm-prefix] {name}: universe {dom.universe_size():.3g} "
                  f"cells, measure+reconstruct refused: MemoryError({msg!r})")
            continue
        records = synthetic_records(dom, ADULT_RECORDS, SEED)
        margs = marginals_from_records(dom, plan.cliques, records)
        reset_chain_stats()
        t0 = time.perf_counter()
        tables, _ = PlusEngine(plan, device="cuda").release(margs, cuda_gen())
        torch.cuda.synchronize()
        t_rp = time.perf_counter() - t0
        counts.append(chain_stats())
        rp_worst = check_plus_tables(plan, tables, margs, 6.0)
        rp_sq = rp_n = 0.0
        for c in wk.cliques:
            want = kron_matvec_np([schema.bases[i].W for i in c], margs[c],
                                  dom.clique_sizes(c)) if c else margs[c]
            rp_sq += float(((tables[c] - want) ** 2).sum())
            rp_n += want.size
        x_host = np.bincount(np.ravel_multi_index(records.T, dom.sizes),
                             minlength=dom.universe_size()).astype(np.float64)
        exact = [kron_matvec_np(sub.factors_W, x_host, dom.sizes)
                 for sub in union.subs]
        hd_counts, hd = hdmm_release(union, dom,
                                     universe_vector(dom, records), exact)
        counts.append(hd_counts)
        print(f"[hdmm-prefix] {name}: {dom.universe_size()} cells; RP+ "
              f"release {t_rp:.3f} s, worst {rp_worst:.3f} sigma, empirical "
              f"RMSE {math.sqrt(rp_sq / rp_n):.3f}; HDMM measure+reconstruct "
              f"{hd['secs']:.3f} s, peak device memory "
              f"{hd['peak'] / 2**30:.3f} GiB, worst {hd['worst']:.3f} sigma, "
              f"empirical RMSE {math.sqrt(hd['sq'] / hd['n']):.3f}; launches "
              f"HDMM {hd_counts} | {card}")
        if not (hd_counts["axis_launches"] > 0
                and hd_counts["fused_launches"] == 0):
            raise AssertionError(f"{name}: HDMM's chains did not take the "
                                 f"per-axis route: {hd_counts}")
    return counts


# [lm-serve]: the LM plane's serving path at the published widths of one
# dense model and of the larger sub-quadratic (hybrid) one, with
# examples/serve_lm.py's traffic: 4 requests of 32 prompt tokens, 16 greedy
# tokens each.
LM_FULL = ("qwen3-4b", "recurrentgemma-2b")
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16
LM_F32_REL = 1e-4        # of max|logit|: decode vs teacher-forced prefill
# the same at bf16 compute: [adult-bf16]'s bound, or the bf16 prefill's own
# distance from the float32 prefill where that is larger (PERF.md, PR 21)
LM_BF16_REL = 3e-2
LM_CARD_CPU_REL = 1e-4   # of max|CPU logit|, float32, TF32 off
LM_CARD_CPU_STEPS = 3


def load_serve_example():
    """examples/serve_lm_torch.py as a module: the user's serving loop."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "serve_lm_torch.py")
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_extend(model, batch, tok):
    """``batch`` with ``tok`` (B, 1) appended as the decode step embeds it."""
    out = dict(batch)
    if model.cfg.frontend == "none":
        out["tokens"] = torch.cat([batch["tokens"], tok.to(batch["tokens"].dtype)],
                                  dim=1)
    else:
        out["embeds"] = torch.cat([batch["embeds"],
                                   model.token_embeds(tok).to(batch["embeds"].dtype)],
                                  dim=1)
    return out


def lm_consistency(model, batch, steps, ref32=None):
    """Greedy decode of ``steps`` tokens; each step's logits against the
    teacher-forced prefill of the prompt plus the tokens so far.  Returns
    the largest gap, relative to that prefill's max |logit|; with ``ref32``
    (the same weights at float32 compute) also the largest gaps of the
    decode and of the teacher-forced prefill from ``ref32``'s prefill."""
    S = batch.get("tokens", batch.get("embeds")).shape[1]
    logits, caches = model.prefill(batch, cache_len=S + steps)
    gap = dec32 = pre32 = 0.0
    for t in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        batch = lm_extend(model, batch, tok)
        logits, caches = model.decode_step(tok, caches, S + t)
        want, _ = model.prefill(batch)
        gap = max(gap, rel_err(logits.float(), want.float()))
        if ref32 is not None:
            truth, _ = ref32.prefill(batch)
            dec32 = max(dec32, rel_err(logits.float(), truth))
            pre32 = max(pre32, rel_err(want.float(), truth))
    return gap if ref32 is None else (gap, dec32, pre32)


def lm_decode_profile(model, batch, steps=4):
    """Of a decode step at the end of ``batch``'s prompt (after a 2-step
    warm-up): the mean wall ms of ``steps`` steps, then, of one more step
    under torch.profiler, device ms, kernel launches and the device ms of
    the kernels that cast weights to bf16."""
    from torch.profiler import ProfilerActivity, profile
    S = batch.get("tokens", batch.get("embeds")).shape[1]
    logits, caches = model.prefill(batch, cache_len=S + steps + 3)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(2):
        model.decode_step(tok, caches, S + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        model.decode_step(tok, caches, S + 2 + i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(tok, caches, S + 2 + steps)
        torch.cuda.synchronize()
    kern = [ev for ev in prof.key_averages()      # kernels: device time,
            if ev.self_device_time_total > 0      # not runtime API calls
            and not ev.key.startswith(("Memcpy", "Memset"))]
    dev = sum(ev.self_device_time_total for ev in kern) / 1e3
    casts = sum(ev.self_device_time_total for ev in kern
                if "bfloat16_copy_kernel" in ev.key) / 1e3
    return wall, dev, sum(ev.count for ev in kern), casts


def phase_lm_serve(card):
    """[lm-serve] the LM plane's serving path (repro_torch.models).

    Qwen3-4B and RecurrentGemma-2B at their published widths, weights from
    a seeded generator on the card (float32, bf16 compute): seconds to
    initialise, prefill seconds, decode tokens/s and peak device memory of
    examples/serve_lm_torch.py's loop (after a 2-token warm-up), the first
    request's tokens.  Gates: every decode step's logits against the
    teacher-forced prefill of the prompt plus the tokens so far, at float32
    compute (rel 1e-4 of max|logit|) and at bf16 (rel 3e-2, or the bf16
    prefill's own distance from the float32 prefill on the same tokens
    where that is larger: the bf16 rounding noise of the model's depth,
    PERF.md PR 21); two greedy runs
    of Qwen3-4B from the same seed give the same tokens.  Then all ten
    architectures at reduced_config on the card and on the CPU from one set
    of weights: prefill logits and 3 decode steps within rel 1e-4."""
    import dataclasses
    from repro_torch.configs import ARCH_IDS, load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models import Model, get_config
    load_all()
    serve = load_serve_example()
    t_phase = time.perf_counter()
    for arch in LM_FULL:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model.init(cfg, cuda_gen(), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        batch = serve.make_batch(model, LM_BATCH, LM_PROMPT, SEED)
        serve.serve_batch(model, batch, 2)
        toks, st = serve.serve_batch(model, batch, LM_GEN)
        peak = torch.cuda.max_memory_allocated()
        print(f"[lm-serve] {arch}: {n_params / 1e9:.3f}B parameters "
              f"(float32, bf16 compute), {LM_BATCH} requests x {LM_PROMPT} "
              f"prompt tokens, {LM_GEN} greedy tokens: init {init_s:.3f} s, "
              f"prefill {st['prefill_s']:.4f} s, decode "
              f"{st['decode_tok_per_s']:.1f} tokens/s ({st['decode_s']:.4f} s "
              f"for {LM_GEN - 1} steps), peak device memory "
              f"{peak / 2**30:.3f} GiB | {card}")
        print(f"[lm-serve] {arch}: first request's tokens {toks[0].tolist()}")
        wall, dev, n_kern, casts = lm_decode_profile(model, batch)
        floor = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 3.35e12 * 1e3
        print(f"[lm-serve] {arch}: one decode step: {wall:.3f} ms of wall "
              f"(mean of 4); under the profiler {dev:.3f} ms of device time "
              f"in {n_kern} kernels, {casts:.3f} ms of it casting weights to "
              f"bf16; byte floor {floor:.3f} ms (the weights read once at "
              f"3.35 TB/s)")
        t0 = time.perf_counter()
        m32 = Model.from_params(dataclasses.replace(cfg, compute_dtype="float32"),
                                model.tree(), device="cuda")
        gap32 = lm_consistency(m32, batch, LM_GEN)
        gap16, dec32, pre32 = lm_consistency(model, batch, LM_GEN, ref32=m32)
        bound16 = max(LM_BF16_REL, pre32)
        print(f"[lm-serve] {arch}: decode vs teacher-forced prefill over "
              f"{LM_GEN} steps, of max|logit|: float32 {gap32:.3e} (bound "
              f"{LM_F32_REL:g}); bf16 {gap16:.3e} (bound {bound16:.3e}); "
              f"from the float32 prefill: bf16 decode {dec32:.3e}, bf16 "
              f"prefill {pre32:.3e}; {time.perf_counter() - t0:.3f} s")
        if not gap32 <= LM_F32_REL:
            raise AssertionError(f"{arch}: float32 decode misses its "
                                 f"teacher-forced prefill by {gap32:.3e}")
        if not gap16 <= bound16:
            raise AssertionError(f"{arch}: bf16 decode misses its "
                                 f"teacher-forced prefill by {gap16:.3e}")
        del m32, model
        if arch == "qwen3-4b":
            torch.cuda.empty_cache()
            model = Model.init(cfg, cuda_gen(), device="cuda")
            again, _ = serve.serve_batch(
                model, serve.make_batch(model, LM_BATCH, LM_PROMPT, SEED),
                LM_GEN)
            del model
            if not torch.equal(again, toks):
                raise AssertionError(f"{arch}: two greedy runs from seed "
                                     f"{SEED} differ:\n{toks}\n{again}")
            print(f"[lm-serve] {arch}: a second run from seed {SEED} gave "
                  f"the same {tuple(toks.shape)} tokens")
    torch.cuda.empty_cache()
    worst = {}
    for arch in ARCH_IDS:
        cpu = Model.init(reduced_config(arch), torch.Generator().manual_seed(SEED),
                         device="cpu")
        dev = Model.from_params(cpu.cfg, cpu.tree(), device="cuda")
        batch = serve.make_batch(cpu, 2, 10, SEED)
        want, wc = cpu.prefill(batch, cache_len=10 + LM_CARD_CPU_STEPS)
        got, gc = dev.prefill({k: v.cuda() for k, v in batch.items()},
                              cache_len=10 + LM_CARD_CPU_STEPS)
        errs = [rel_err(got.cpu(), want)]
        for t in range(LM_CARD_CPU_STEPS):
            tok = want[:, -1].argmax(-1)[:, None]
            want, wc = cpu.decode_step(tok, wc, 10 + t)
            got, gc = dev.decode_step(tok.cuda(), gc, 10 + t)
            errs.append(rel_err(got.cpu(), want))
        worst[arch] = max(errs)
        if not worst[arch] <= LM_CARD_CPU_REL:
            raise AssertionError(f"{arch} (reduced): card against CPU "
                                 f"{errs} (bound {LM_CARD_CPU_REL:g})")
    print("[lm-serve] reduced configs, card against CPU (prefill + "
          f"{LM_CARD_CPU_STEPS} decode steps, rel of max|logit|): "
          + ", ".join(f"{a} {e:.2e}" for a, e in worst.items()))
    print(f"[lm-serve] {time.perf_counter() - t_phase:.1f} s in all")


# [lm-train]: the LM plane's training path.  Qwen3-4B at its published
# widths and full depth takes 6 steps on one fixed batch; xLSTM-350M takes
# 3 DP-SGD steps; the ten reduced configs one step each on the card and on
# the CPU; train_loop resumes bit for bit; the DP corpus example spends one
# budget on a kernel-backed release and on DP-SGD steps.
LM_TRAIN_ARCH, LM_DP_ARCH = "qwen3-4b", "xlstm-350m"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_DP_STEPS = 8, 128, 6, 3
# the first step's loss (mean of 2 microbatch means) against the eval loss
# of the whole batch: equal in exact arithmetic (every label counts, both
# halves hold 512 tokens), and every chip run so far read a gap of 0; 1e-5
# leaves room for float32 sums of the token losses in another order
# (about 1e-7) and stays far under a step that lost a microbatch: the
# planted reading, the eval loss of the first half alone against the
# whole, must exceed the bound, or the gate could not catch that fault
LM_TRAIN_EVAL_REL = 1e-5
LM_DP_REL = 1e-4          # vmap against the loop, of each leaf's max
LM_NOISE_SE = 5.0         # noise mean and std, in standard errors
LM_TRAIN_CARD_CPU_REL = 1e-4


def step_profile(step, state, batch, top=8):
    """Device ms and kernel launches of one more step under torch.profiler
    (kernels only, as lm_decode_profile counts them), and the ``top``
    kernels by device time as (ms, launches, name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kern = sorted((ev for ev in prof.key_averages()
                   if ev.self_device_time_total > 0
                   and not ev.key.startswith(("Memcpy", "Memset"))),
                  key=lambda ev: -ev.self_device_time_total)
    return (state, sum(ev.self_device_time_total for ev in kern) / 1e3,
            sum(ev.count for ev in kern),
            [(ev.self_device_time_total / 1e3, ev.count, short_kernel(ev.key))
             for ev in kern[:top]])


def short_kernel(key: str) -> str:
    """A profiler kernel key cut to its kernel and the functors or ATen
    kernels named in its template arguments (what the elementwise kernels
    compute)."""
    import re
    base = key.replace("void ", "").split("<", 1)[0].split("::")[-1]
    named = re.findall(r"(\w+(?:Functor|_kernel_cuda|_kernel_impl)\w*)", key)
    inner = ",".join(list(dict.fromkeys(n for n in named if n != base))[:2])
    return f"{base}[{inner}]" if inner else base[:60]


def free_device_memory():
    """Collect garbage, then return the cached blocks: a freed model caught
    in a reference cycle (on the CPU the first remat call's lazy imports
    leave one holding that step's frames) keeps its memory until the
    collector runs."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def lm_train_batch(cfg, seed=SEED):
    from repro_torch.data.tokens import synthetic_lm_batches
    b = next(synthetic_lm_batches(cfg.vocab_size, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                  seed=seed))
    return {k: torch.as_tensor(b[k], device="cuda") for k in ("tokens", "labels")}


def lm_train_full(card):
    """(a) Qwen3-4B at full width: 6 steps of 2 microbatches, "dots"."""
    from repro_torch.models import Model, get_config, transformer
    from repro_torch.train import AdamWConfig, make_eval_step, make_train_step
    from repro_torch.train.train_step import init_train_state
    cfg = get_config(LM_TRAIN_ARCH)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model.init(cfg, cuda_gen(), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = lm_train_batch(cfg)
    eval_step = make_eval_step(model)
    eval_loss = float(eval_step(model.tree(), batch))
    half = float(eval_step(model.tree(), {k: v[:LM_TRAIN_BATCH // 2]
                                         for k, v in batch.items()}))
    planted = abs(half - eval_loss) / abs(eval_loss)
    oc = AdamWConfig(lr=1e-3, warmup_steps=20)
    transformer.set_remat_policy("dots")
    state = init_train_state(model, oc)
    step = make_train_step(model, oc, microbatches=2, remat=True)
    losses, norms, secs = [], [], []
    for _ in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    state, dev_ms, n_kern, top = step_profile(step, state, batch)
    # the same step under remat "nothing" (plain recomputation, no dispatch
    # mode); without remat the saved bf16 weight casts do not fit the card
    transformer.set_remat_policy("nothing")
    try:
        nothing = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            float(met["loss"])
            nothing.append(time.perf_counter() - t0)
        state, dev_nothing, kern_nothing, _ = step_profile(step, state, batch)
    finally:
        transformer.set_remat_policy("dots")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = sum(secs[1:]) / len(secs[1:])
    print(f"[lm-train] {LM_TRAIN_ARCH}: {n_params / 1e9:.3f}B parameters "
          f"(float32, bf16 compute), {cfg.n_layers} layers, batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in 2 microbatches, remat "
          f"'dots', AdamW float32 moments: init {init_s:.3f} s; step 1 "
          f"{secs[0]:.3f} s, steps 2-{LM_TRAIN_STEPS} "
          + ", ".join(f"{s:.4f}" for s in secs[1:])
          + f" s (mean {steady:.4f} s, {tokens / steady:.1f} tokens/s); peak "
          f"device memory {peak / 2**30:.3f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.3f}; "
          f"one more step under the profiler {dev_ms:.3f} ms of device time "
          f"in {n_kern} kernels; the next 3 steps under remat 'nothing' "
          + ", ".join(f"{v:.4f}" for v in nothing)
          + f" s, one more {dev_nothing:.3f} ms of device time in "
          f"{kern_nothing} kernels | {card}")
    print(f"[lm-train] {LM_TRAIN_ARCH}: losses "
          + ", ".join(f"{v:.6f}" for v in losses) + "; grad norms "
          + ", ".join(f"{v:.4f}" for v in norms)
          + f"; eval loss of the initial weights {eval_loss:.6f} (step 1 off "
          f"by {abs(losses[0] - eval_loss) / abs(eval_loss):.3e}, bound "
          f"{LM_TRAIN_EVAL_REL:.3e}; a step of the first microbatch alone "
          f"would be off by {planted:.3e}); the profiled step's top kernels (ms, "
          f"launches): " + "; ".join(f"{n} {ms:.3f} x{c}" for ms, c, n in top))
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{LM_TRAIN_ARCH}: a loss or grad norm is not "
                             f"finite: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{LM_TRAIN_ARCH}: the loss did not fall: {losses}")
    if not abs(losses[0] - eval_loss) <= LM_TRAIN_EVAL_REL * abs(eval_loss):
        raise AssertionError(f"{LM_TRAIN_ARCH}: step 1's loss {losses[0]} "
                             f"against the eval loss {eval_loss}")
    if not planted > LM_TRAIN_EVAL_REL:
        raise AssertionError(f"{LM_TRAIN_ARCH}: the eval gate cannot tell a "
                             f"lost microbatch ({planted:.3e})")
    del model, state, step


def clipped_loop(model, batch, clip):
    """Mean of single-example gradients (torch.func.grad), each clipped to
    ``clip``, summed as they come."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.train_step import functional_loss
    loss = functional_loss(model)
    B = next(iter(batch.values())).shape[0]
    acc = None
    for i in range(B):
        g = tree_leaves(torch.func.grad(loss)(
            model.tree(), {k: v[i:i + 1] for k, v in batch.items()}))
        n = torch.sqrt(sum(torch.sum(x.float() ** 2) for x in g))
        s = torch.clamp(clip / torch.clamp_min(n, 1e-12), max=1.0)
        acc = [x * s for x in g] if acc is None else \
            [a.add_(x * s) for a, x in zip(acc, g)]
        del g
    return [a / B for a in acc]


def lm_train_dp(card):
    """(b) DP-SGD on xLSTM-350M at full width."""
    import dataclasses
    from repro_torch.models import Model, get_config
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.dp import (DPSGDAccountant, DPSGDConfig,
                                      add_dp_noise, per_example_clipped_grad)
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train.train_step import functional_loss, init_train_state
    cfg = get_config(LM_DP_ARCH)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, cuda_gen(), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    batch = lm_train_batch(cfg)
    dpc = DPSGDConfig(clip_norm=1.0, noise_multiplier=1.0)
    oc = AdamWConfig(lr=1e-3, warmup_steps=20)
    # vmap against the loop, float32 compute, before any step moves the
    # weights, on the first pattern group (2 layers) at full width: through
    # the random-weight recurrences float32 rounding grows with depth, and
    # at 24 layers two vmap batchings of one function (8 against 4 x 2
    # examples) already differ by 3e-3 of max|g|; the same model code in
    # float64 puts vmap against the loop at 7e-12 there, so the float32
    # gap is rounding, not vmap (tools/lm_dp_vmap_gap.py [--float64])
    head = dict(model.tree(), blocks=model.tree()["blocks"][:1])
    m32 = Model.from_params(dataclasses.replace(
        cfg, n_layers=len(cfg.pattern), compute_dtype="float32"), head,
        device="cuda")
    t0 = time.perf_counter()
    got = tree_leaves(per_example_clipped_grad(functional_loss(m32),
                                               m32.tree(), batch, dpc.clip_norm))
    torch.cuda.synchronize()
    vmap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = clipped_loop(m32, batch, dpc.clip_norm)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    dp_err = max(rel_err(g, w) for g, w in zip(got, want))
    del got, want, m32
    state = init_train_state(model, oc)
    rng0 = state["rng"].clone()
    step = make_train_step(model, oc, microbatches=2, dp=dpc)
    acct = DPSGDAccountant(dpc)
    losses, secs = [], []
    for _ in range(LM_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
        acct.charge_step()
    peak = torch.cuda.max_memory_allocated()
    # the first step's noise, replayed from the state's generator
    gen = torch.Generator("cuda")
    gen.set_state(rng0)
    zeros = tree_map(lambda p: torch.zeros_like(p), model.tree())
    noise = tree_leaves(add_dp_noise(zeros, gen, dpc.clip_norm,
                                     dpc.noise_multiplier, LM_TRAIN_BATCH))
    n = sum(x.numel() for x in noise)
    s1 = sum(float(x.double().sum()) for x in noise)
    s2 = sum(float((x.double() ** 2).sum()) for x in noise)
    del noise, zeros
    mean, std = s1 / n, math.sqrt(s2 / n - (s1 / n) ** 2)
    want_std = dpc.clip_norm * dpc.noise_multiplier / LM_TRAIN_BATCH
    mean_se, std_se = mean / (want_std / math.sqrt(n)), \
        (std - want_std) / (want_std / math.sqrt(2 * n))
    report = acct.report()
    print(f"[lm-train] {LM_DP_ARCH}: {n_params / 1e9:.3f}B parameters, DP-SGD "
          f"(C {dpc.clip_norm}, sigma {dpc.noise_multiplier}), batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in 2 microbatches: step seconds "
          + ", ".join(f"{s:.3f}" for s in secs) + "; losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f"; peak device memory {peak / 2**30:.3f} GiB; accountant {report} "
          f"| {card}")
    print(f"[lm-train] {LM_DP_ARCH}: vmap clipped mean against a loop of "
          f"{LM_TRAIN_BATCH} single-example clipped gradients (the first "
          f"{len(cfg.pattern)} layers at full width, float32, TF32 off) "
          f"{dp_err:.3e} of each leaf's max (bound {LM_DP_REL:g}); vmap "
          f"{vmap_s:.3f} s, loop {loop_s:.3f} s; first step's noise over {n} "
          f"entries: mean {mean:.3e} ({mean_se:+.2f} SE), std {std:.6e} against "
          f"{want_std:.6e} ({std_se:+.2f} SE)")
    if not dp_err <= LM_DP_REL:
        raise AssertionError(f"{LM_DP_ARCH}: vmap clipped mean off the loop by "
                             f"{dp_err:.3e}")
    if not (abs(mean_se) <= LM_NOISE_SE and abs(std_se) <= LM_NOISE_SE):
        raise AssertionError(f"{LM_DP_ARCH}: noise moments {mean_se:+.2f}, "
                             f"{std_se:+.2f} SE")
    if not (all(math.isfinite(v) for v in losses) and report["steps"] == LM_DP_STEPS
            and abs(report["pcost"] - LM_DP_STEPS / dpc.noise_multiplier ** 2)
            <= 1e-12):
        raise AssertionError(f"{LM_DP_ARCH}: DP run {losses} {report}")
    del model, state, step


# The AdamW of every float32 step held to another: eps 1e-4 bounds Adam's
# first-step amplification of a gradient's last bits at 1e4 (at 1e-8 a
# near-zero entry may move by lr).
LM_ADAMW = {"lr": 1e-3, "warmup_steps": 20, "eps": 1e-4}


def lm_train_card_cpu():
    """(c) one step of each reduced architecture on the card against the
    CPU, and reduced Qwen3-4B's DP clipped mean."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.dp import per_example_clipped_grad
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train.train_step import functional_loss, init_train_state
    oc = AdamWConfig(**LM_ADAMW)
    worst = {}
    for arch in ARCH_IDS:
        cpu = Model.init(reduced_config(arch), torch.Generator().manual_seed(SEED),
                         device="cpu")
        # a copy: the CPU step updates its weights in place
        dev = Model.from_params(cpu.cfg, tree_map(torch.clone, cpu.tree()),
                                device="cuda")
        gen = torch.Generator().manual_seed(SEED)
        batch = {"labels": torch.randint(0, cpu.cfg.vocab_size, (4, 16),
                                         generator=gen)}
        if cpu.cfg.frontend == "none":
            batch["tokens"] = torch.randint(0, cpu.cfg.vocab_size, (4, 16),
                                            generator=gen)
        else:
            batch["embeds"] = torch.randn((4, 16, cpu.cfg.d_model), generator=gen)
        if cpu.cfg.encoder_layers:
            batch["enc_embeds"] = torch.randn(
                (4, cpu.cfg.encoder_seq, cpu.cfg.d_model), generator=gen)
        out = []
        for m, b in ((cpu, batch), (dev, {k: v.cuda() for k, v in batch.items()})):
            st, met = make_train_step(m, oc, microbatches=2, remat=True)(
                init_train_state(m, oc), b)
            out.append((float(met["loss"]), tree_leaves(st["params"])
                        + [x for x in tree_leaves(st["opt"])
                           if x.dtype.is_floating_point]))
        errs = [abs(out[1][0] - out[0][0]) / abs(out[0][0])]
        errs += [rel_err(g.detach().cpu(), w.detach())
                 for g, w in zip(out[1][1], out[0][1])]
        worst[arch] = max(errs)
        if not worst[arch] <= LM_TRAIN_CARD_CPU_REL:
            raise AssertionError(f"{arch} (reduced): a train step on the card "
                                 f"off the CPU's by {worst[arch]:.3e}")
    cpu = Model.init(reduced_config(LM_TRAIN_ARCH),
                     torch.Generator().manual_seed(SEED), device="cpu")
    dev = Model.from_params(cpu.cfg, cpu.tree(), device="cuda")
    gen = torch.Generator().manual_seed(SEED)
    batch = {k: torch.randint(0, cpu.cfg.vocab_size, (4, 16), generator=gen)
             for k in ("tokens", "labels")}
    want = tree_leaves(per_example_clipped_grad(functional_loss(cpu), cpu.tree(),
                                                batch, 0.1))
    got = tree_leaves(per_example_clipped_grad(
        functional_loss(dev), dev.tree(), {k: v.cuda() for k, v in batch.items()},
        0.1))
    dp_err = max(rel_err(g.cpu(), w) for g, w in zip(got, want))
    print("[lm-train] reduced configs, one train step (2 microbatches, 'dots'; "
          "float32, TF32 off) card against CPU, worst of the loss, every "
          "parameter and every moment (rel of each leaf's max): "
          + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
          + f"; DP clipped mean of reduced {LM_TRAIN_ARCH} {dp_err:.2e} (bound "
          f"{LM_TRAIN_CARD_CPU_REL:g})")
    if not dp_err <= LM_TRAIN_CARD_CPU_REL:
        raise AssertionError(f"DP clipped mean on the card off the CPU's by "
                             f"{dp_err:.3e}")


def lm_train_resume():
    """(d) train_loop on the card: 30 steps saving every 10, a resume to
    45, against an uninterrupted 45-step run, losses bit for bit."""
    import contextlib
    import io
    import shutil
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.launch.train import train_loop
    root = os.path.join("build", f"lm_train_ckpt_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    cfg = reduced_config(LM_TRAIN_ARCH)
    run = dict(batch_size=4, seq_len=32, dp=None, microbatches=2,
               ckpt_every=10, device="cuda")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, whole = train_loop(cfg, steps=45, ckpt_dir=os.path.join(root, "a"),
                                  resume=False, **run)
            _, first = train_loop(cfg, steps=30, ckpt_dir=os.path.join(root, "b"),
                                  resume=False, **run)
            _, rest = train_loop(cfg, steps=45, ckpt_dir=os.path.join(root, "b"),
                                 resume=True, **run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = first + rest == whole
    print(f"[lm-train] train_loop resume on the card (reduced {LM_TRAIN_ARCH}, "
          f"30 steps saving every 10, resumed to 45): steps 30-44 equal to an "
          f"uninterrupted run's bit for bit {same}; losses {whole[0]:.6f} -> "
          f"{whole[-1]:.6f}; {time.perf_counter() - t0:.3f} s")
    if not same:
        diff = [i for i, (a, b) in enumerate(zip(first + rest, whole)) if a != b]
        raise AssertionError(f"resumed losses differ at steps {diff}")


def lm_train_corpus(card):
    """(e) examples/dp_corpus_stats_torch.py's main on the card."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "dp_corpus_stats_torch.py")
    spec = importlib.util.spec_from_file_location("dp_corpus_stats_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    reset_chain_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tables, steps, report = mod.main([])
    secs = time.perf_counter() - t0
    counts = chain_stats()
    print(f"[lm-train] dp_corpus_stats_torch: release + {steps} funded DP-SGD "
          f"steps in {secs:.3f} s; accountant {report}; launches {counts} | "
          f"{card}")
    if not (steps == 3 and report["steps"] == 3
            and counts["fused_launches"] > 0):
        raise AssertionError(f"corpus example: {steps} steps, {counts}")
    return counts


def phase_lm_train(card):
    """[lm-train] the LM plane's training path (repro_torch.train).

    (a) Qwen3-4B at its published widths and full depth (4.411B float32
    parameters, bf16 compute): 6 steps of make_train_step (2 microbatches,
    remat "dots", AdamW float32 moments) on one batch of 8 x 128 tokens:
    init seconds, step 1's seconds and steps 2-6's, tokens/s, peak device
    memory, each step's loss and grad norm, device ms and kernel launches of
    one more step (torch.profiler).  Gates: every loss and grad norm finite,
    the sixth loss below the first, the first within rel 1e-5 of
    make_eval_step on the initial weights over the whole batch, and the
    first microbatch's eval loss alone (a planted lost microbatch) off the
    whole batch's by more than that bound.
    (b) DP-SGD on xLSTM-350M at full width (clip 1, sigma 1, 8 x 128 in 2
    microbatches, 3 steps): seconds per step, peak memory, the accountant
    (pcost 3).  Gates: the vmap per-example clipped mean equals a loop of 8
    single-example clipped gradients within rel 1e-4 of each leaf's max, on
    the first 2 layers at full width (float32 compute, TF32 off; deeper,
    float32 rounding grows through the recurrences past that bound for
    any two batchings, and tools/lm_dp_vmap_gap.py --float64 holds the 24
    layers); the first step's noise over all 0.229B entries
    has mean and std within 5 standard errors of 0 and C*sigma/B.
    (c) All ten architectures at reduced_config: one train step on the card
    against the CPU (loss, parameters, moments within rel 1e-4; float32,
    TF32 off); reduced Qwen3-4B's DP clipped mean likewise.
    (d) train_loop resume on the card: steps 30-44 bit for bit.
    (e) examples/dp_corpus_stats_torch.py: exactly 3 funded steps, fused
    kernel launches > 0 (counted in the kernels line)."""
    t_phase = time.perf_counter()
    lm_train_full(card)
    lm_train_dp(card)
    free_device_memory()
    lm_train_card_cpu()
    lm_train_resume()
    counts = lm_train_corpus(card)
    print(f"[lm-train] {time.perf_counter() - t_phase:.1f} s in all")
    return counts


# [lm-mesh]: the LM plane's multi-device serving path.  DeepSeek-V2-236B at
# its published width (d 5120, 128 MLA heads, kv_lora 512, 160 experts top
# 6, d_expert 1536, 2 shared, vocabulary 102,400), its depth cut from 60 to
# 4 layers (17.09B parameters, 34.2 GB at bf16: one card holds it, which
# gives the no-mesh comparison), seeded bf16 weights; 2 prompts of 512
# tokens, 8 greedy decode steps.  Its MLA reads no attention sharding mode
# (as the reference's), so on more than one card Qwen3-4B at published
# width (GQA, 32 heads over 8 KV heads, d 2560, vocabulary 151,936), 4 of
# 36 layers, runs the parity gate in both modes: 'seq' and the padded-head
# 'heads' region with its all-reduce over 'model'.
LM_MESH_ARCH = "deepseek-v2-236b"
LM_MESH_LAYERS = 4
LM_MESH_GQA = "qwen3-4b"
LM_MESH_GQA_LAYERS = 4
LM_MESH_B, LM_MESH_S, LM_MESH_STEPS = 2, 512, 8
LM_MESH_REL = 1e-4       # of max|logit|: mesh vs no mesh, float32 compute
# A capacity factor at which nothing drops at these shapes: prefill stage 1
# needs cap1 >= t*k (4 at (1, 4), 2 at (2, 2)); decode at (2, 2) holds 80
# experts a rank and 2 tokens, so cap = ceil(12 / 80 * cf) >= 2 needs 8.
LM_MESH_PARITY_CF = 8.0
LM_MESH_TIMEOUT = 900    # seconds for the ranks to finish


def lm_mesh_config(layers, compute_dtype="bfloat16", capacity_factor=None,
                   arch=LM_MESH_ARCH, reduced=False, heads=None):
    """``arch`` at published width, ``layers`` deep (at most one tail group
    among them, and as many encoder layers); ``reduced``: its reduced
    config, with ``heads`` heads (and KV heads) of its head width where
    given."""
    import dataclasses
    from repro_torch.configs import load_all, shapes
    from repro_torch.models import get_config
    load_all()
    if reduced:
        cfg = shapes.reduced_config(arch)
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    else:
        cfg = get_config(arch)
        cfg = dataclasses.replace(
            cfg, n_layers=layers, n_tail=min(cfg.n_tail, 1),
            encoder_layers=min(cfg.encoder_layers, layers))
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def lm_mesh_meshes(world):
    """The meshes a run of ``world`` ranks serves on."""
    if world == 1:
        return [(1, 1)]
    return [(1, world)] + ([(2, world // 2)] if world % 2 == 0 else [])


def lm_mesh_retarget(model, cfg):
    """Point the model and each of its blocks at ``cfg`` (compute dtype,
    capacity factor); the weights stay."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = cfg


def lm_mesh_prompt(cfg):
    """The seeded prompt on the host: tokens (B, S), and an encoder-decoder's
    input frames (B, encoder_seq, d), standard normal."""
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (LM_MESH_B, LM_MESH_S)).astype(np.int64)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (LM_MESH_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def lm_mesh_a2a_bytes(cfg, shape):
    """Bytes one prefill all_to_all of activations moves out of each rank:
    cap1 rows of d bf16 values for each of the n_shards ranks, cap1 from the
    tokens a rank dispatches (its sequence chunk, gathered over data)."""
    nd, n = shape
    if n == 1:
        return 0
    t = LM_MESH_B * LM_MESH_S // n
    cap1 = math.ceil(t * cfg.moe.top_k / n * cfg.moe.capacity_factor)
    return cap1 * cfg.d_model * 2 * n


def lm_mesh_serve(model, prompt, steps, forced=None, spare=0):
    """Prefill ``prompt`` (:func:`lm_mesh_prompt`) and decode ``steps``
    tokens (greedy, or the ``forced`` ones), ``spare`` cache slots left
    over.  Returns (prefill logits, [decode logits], tokens, caches)."""
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in prompt.items()}
    logits, caches = model.prefill(batch, cache_len=LM_MESH_S + steps + spare)
    out, toks = [], []
    cur = logits
    for t in range(steps):
        tok = (cur[:, -1].argmax(-1)[:, None] if forced is None
               else torch.as_tensor(forced[t], device="cuda"))
        toks.append(tok.cpu().numpy())
        cur, caches = model.decode_step(tok, caches, LM_MESH_S + t)
        out.append(cur)
    return logits, out, toks, caches


def lm_mesh_run(arch, shape, layers, modes, bf16):
    """One run of ``_lm_mesh_rank``: ``arch`` ``layers`` deep on a mesh of
    ``shape``, the parity gate in each attention mode of ``modes`` (where
    the job has the arch's no-mesh reference), then the bf16 measurements
    when ``bf16``."""
    return {"arch": arch, "shape": list(shape), "layers": layers,
            "modes": list(modes), "bf16": bf16}


def nccl_rank(rank, world, store, seconds):
    """Join rank ``rank`` of a ``world``-rank NCCL group through the
    FileStore ``store`` on card ``rank``, TF32 off (a spawned rank's
    first step)."""
    import datetime
    import torch.distributed as dist
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=seconds))


def _lm_mesh_rank(rank, world, store, job, out_path):
    """One NCCL rank of [lm-mesh] (spawned): for each run, the seeded model
    placed on its mesh; at float32 compute and LM_MESH_PARITY_CF the prompt
    prefilled and the reference's tokens decoded in each attention mode,
    its logits held against the no-mesh run's; then, for a bf16 run, at
    bf16 and the config's capacity factor: prefill seconds, decode
    tokens/s, peak memory, dropped pairs, NCCL device ms of one decode
    step and the collective bytes of one more (``OpStats``).  Rank 0
    writes what it measured to ``out_path``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_stats, reset_moe_stats
    nccl_rank(rank, world, store, 120)
    report = {"world": world, "runs": []}

    def summed(vals):
        t = torch.tensor(vals, dtype=torch.float64, device="cuda")
        dist.all_reduce(t)
        return t.tolist()

    def gathered(val):
        out = [None] * world
        dist.all_gather_object(out, val)
        return out

    try:
        for spec in job["runs"]:
            arch, shape, layers = spec["arch"], tuple(spec["shape"]), spec["layers"]
            ref_path = job["refs"].get(arch)
            ref = np.load(ref_path) if ref_path else None
            mesh = make_host_mesh("cuda", shape)
            cfg = lm_mesh_config(layers, arch=arch)
            prompt = lm_mesh_prompt(cfg)
            tokens = prompt["tokens"]
            free_device_memory()
            t0 = time.perf_counter()
            model = Model.init(cfg, cuda_gen(), mesh=mesh)
            torch.cuda.synchronize()
            run = {"arch": arch, "shape": list(shape), "layers": layers,
                   "moe": cfg.moe is not None,
                   "init_s": time.perf_counter() - t0, "parity": {}}
            if ref is not None:
                lm_mesh_retarget(model, lm_mesh_config(
                    layers, "float32", LM_MESH_PARITY_CF, arch))
                for mode in spec["modes"]:
                    L.set_attn_sharding(mode)
                    reset_moe_stats()
                    try:
                        logits, dec, _, _ = lm_mesh_serve(
                            model, prompt, LM_MESH_STEPS, forced=ref["tokens"])
                    finally:
                        L.set_attn_sharding("seq")
                    st = moe_stats()
                    counts = summed([st["ep_dispatch"], st["ep_replicated"],
                                     st["dense"], st["dropped"]])
                    errs = [rel_err(logits.cpu(), torch.as_tensor(ref["prefill"]))]
                    errs += [rel_err(d.cpu(), torch.as_tensor(ref["decode"][i]))
                             for i, d in enumerate(dec)]
                    run["parity"][mode] = {
                        "prefill_rel": errs[0], "decode_rel": max(errs[1:]),
                        "ep_dispatch": counts[0], "ep_replicated": counts[1],
                        "dense": counts[2], "dropped": counts[3]}
                    del logits, dec
            if spec["bf16"]:
                lm_mesh_retarget(model, cfg)
                reset_moe_stats()
                free_device_memory()
                torch.cuda.reset_peak_memory_stats()
                batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
                secs = []
                for _ in range(2):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, caches = model.prefill(
                        batch, cache_len=LM_MESH_S + LM_MESH_STEPS + 3)
                    torch.cuda.synchronize()
                    dist.barrier()
                    secs.append(time.perf_counter() - t0)
                prefill_stats = moe_stats()
                tok = logits[:, -1].argmax(-1)[:, None]
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = []
                for t in range(LM_MESH_STEPS):
                    cur, caches = model.decode_step(tok, caches, LM_MESH_S + t)
                    tok = cur[:, -1].argmax(-1)[:, None]
                    toks.append(tok)
                torch.cuda.synchronize()
                dist.barrier()
                dec_s = time.perf_counter() - t0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    cur, caches = model.decode_step(tok, caches,
                                                    LM_MESH_S + LM_MESH_STEPS)
                    torch.cuda.synchronize()
                kern = [ev for ev in prof.key_averages()
                        if ev.self_device_time_total > 0
                        and not ev.key.startswith(("Memcpy", "Memset"))]
                nccl = sum(ev.self_device_time_total for ev in kern
                           if "nccl" in ev.key.lower()) / 1e3
                dev = sum(ev.self_device_time_total for ev in kern) / 1e3
                coll = _collective_bytes(lambda: model.decode_step(
                    tok, caches, LM_MESH_S + LM_MESH_STEPS + 1))
                finite = bool(torch.isfinite(logits).all()
                              and torch.isfinite(cur).all())
                st = moe_stats()
                counts = summed([st["ep_dispatch"], st["ep_replicated"],
                                 st["dense"], prefill_stats["dropped"] / 2.0,
                                 st["dropped"]])
                run["bf16"] = {
                    "prefill_s": secs, "decode_tokens_per_s":
                        LM_MESH_B * LM_MESH_STEPS / dec_s,
                    "decode_step_ms": dec_s / LM_MESH_STEPS * 1e3,
                    "peak_gib": gathered(
                        torch.cuda.max_memory_allocated() / 2**30),
                    "card_gib": torch.cuda.get_device_properties(
                        torch.cuda.current_device()).total_memory / 2**30,
                    "nccl_ms": gathered(nccl), "device_ms": gathered(dev),
                    "coll_bytes": gathered(coll),
                    "ep_dispatch": counts[0], "ep_replicated": counts[1],
                    "dense": counts[2], "dropped_prefill": counts[3],
                    "dropped_all": counts[4], "finite": finite,
                    "logits_shape": list(logits.shape),
                    "a2a_bytes": lm_mesh_a2a_bytes(cfg, shape),
                    "tokens": torch.cat(toks, 1).cpu().tolist()}
                del logits, caches, cur
            report["runs"].append(run)
            del model
            free_device_memory()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def lm_mesh_reference(ref_path, arch=LM_MESH_ARCH, layers=LM_MESH_LAYERS):
    """The no-mesh run on card 0 at float32 compute and LM_MESH_PARITY_CF:
    prefill logits, 8 greedy tokens and their decode logits, to the host
    (``ref_path``); the model is freed."""
    from repro_torch.models import Model
    cfg = lm_mesh_config(layers, "float32", LM_MESH_PARITY_CF, arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model.init(cfg, cuda_gen(), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    logits, dec, toks, _ = lm_mesh_serve(model, lm_mesh_prompt(cfg),
                                         LM_MESH_STEPS)
    np.savez(ref_path, prefill=logits.float().cpu().numpy(),
             decode=np.stack([d.float().cpu().numpy() for d in dec]),
             tokens=np.stack(toks))
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, logits, dec
    free_device_memory()
    return n_params, secs, peak


def lm_mesh_spawn(job, world, tag, target=None, timeout=LM_MESH_TIMEOUT):
    """Run ``target`` (default ``_lm_mesh_rank``) on ``world`` spawned NCCL
    ranks (a FileStore under build/); returns rank 0's report.  Any rank
    that fails or outlives ``timeout`` seconds fails the phase."""
    import torch.multiprocessing as mp
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.makedirs("build", exist_ok=True)
    store = os.path.join("build", f"lm_mesh_store_{tag}_{os.getpid()}")
    out = os.path.join("build", f"lm_mesh_{tag}_{os.getpid()}.json")
    for f in (store, out):
        if os.path.exists(f):
            os.remove(f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or _lm_mesh_rank,
                         args=(r, world, store, job, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(timeout=max(deadline - time.time(), 1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    if os.path.exists(store):
        os.remove(store)
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"[lm-mesh] ranks failed: exit codes "
                             f"{[p.exitcode for p in procs]}"
                             + (" (timed out)" if hung else ""))
    with open(out) as f:
        report = json.load(f)
    os.remove(out)
    return report


def lm_mesh_print(report, gates=True):
    """Print a report of ``_lm_mesh_rank`` and hold it to the gates."""
    world = report["world"]
    for run in report["runs"]:
        shape = tuple(run["shape"])
        ep_expected = run["moe"] and shape[1] > 1
        tag = (f"[lm-mesh] world {world} mesh {shape} {run['arch']} "
               f"{run['layers']} layers")
        print(f"{tag}: init {run['init_s']:.1f} s")
        for mode, par in run["parity"].items():
            print(f"{tag} float32 cf {LM_MESH_PARITY_CF} attention '{mode}': "
                  f"prefill rel {par['prefill_rel']:.3e}, decode rel "
                  f"{par['decode_rel']:.3e} (bound {LM_MESH_REL}); dropped "
                  f"{par['dropped']:.0f}; EP dispatch/replicated/dense calls "
                  f"{par['ep_dispatch']:.0f}/{par['ep_replicated']:.0f}/"
                  f"{par['dense']:.0f}")
            if gates:
                assert par["prefill_rel"] < LM_MESH_REL, par
                assert par["decode_rel"] < LM_MESH_REL, par
                assert par["dropped"] == 0, par
                if ep_expected:
                    assert par["ep_dispatch"] > 0 and par["ep_replicated"] > 0 \
                        and par["dense"] == 0, par
                elif run["moe"]:
                    assert par["ep_dispatch"] == 0 and par["ep_replicated"] == 0 \
                        and par["dense"] > 0, par
        if "bf16" not in run:
            continue
        b = run["bf16"]
        vocab = lm_mesh_config(1, arch=run["arch"]).vocab_size
        print(f"{tag} bf16 cf {lm_mesh_config(1).moe.capacity_factor}: "
              f"prefill {b['prefill_s'][0]:.3f} s first, "
              f"{b['prefill_s'][1]:.3f} s second; decode "
              f"{b['decode_tokens_per_s']:.1f} tokens/s "
              f"({b['decode_step_ms']:.2f} ms a step); peak GiB per rank "
              f"{[round(g, 3) for g in b['peak_gib']]} of "
              f"{b['card_gib']:.1f}; dropped pairs {b['dropped_prefill']:.0f} "
              f"in a prefill, {b['dropped_all']:.0f} in all; one decode step's "
              f"device ms per rank {[round(x, 3) for x in b['device_ms']]}, "
              f"of it NCCL {[round(x, 3) for x in b['nccl_ms']]}; the next "
              f"step's collective bytes per rank {_coll_line(b['coll_bytes'])}; "
              f"all_to_all bytes out of a rank per dispatch {b['a2a_bytes']:,}; "
              f"EP dispatch/replicated/dense calls {b['ep_dispatch']:.0f}/"
              f"{b['ep_replicated']:.0f}/{b['dense']:.0f}")
        if run["moe"] and not ep_expected:
            print(f"{tag}: model axis 1, so the expert-parallel bodies did not "
                  f"run (the dense path, as the reference's)")
        if gates:
            assert b["finite"] and b["logits_shape"] == [LM_MESH_B, 1, vocab], b
            if ep_expected:
                assert b["ep_dispatch"] > 0 and b["ep_replicated"] > 0 \
                    and b["dense"] == 0, b


def phase_lm_mesh(card):
    """[lm-mesh] the LM plane's multi-device serving path
    (repro_torch.models.sharding, repro_torch.launch.mesh).

    DeepSeek-V2-236B at published width, 4 of 60 layers, seeded bf16
    weights; 2 prompts of 512 tokens, 8 decode steps.  First the no-mesh
    model on card 0 at float32 compute and capacity factor 8 (prefill
    logits, 8 greedy tokens and their logits to the host; freed).  Then one
    NCCL rank per visible card, up to four (a FileStore under build/,
    NCCL_SOCKET_IFNAME=lo, 120 s timeouts): on four cards (1, 4) and
    (2, 2), on one card (1, 1) through a one-rank group, where the model
    axis is 1 and the expert-parallel bodies do not run.  DeepSeek-V2's MLA
    reads no attention sharding mode, so it runs 'seq'; on more than one
    card Qwen3-4B at published width, 4 of 36 layers, runs the parity gate
    on each mesh in both modes ('seq', and 'heads' with its padded-head
    region and all-reduce), against its own no-mesh run on card 0.  Gates:
    at float32 (and capacity factor 8) the mesh's prefill logits and its 8
    decode steps (the reference's tokens fed) within rel 1e-4 of max|logit|
    of the no-mesh run, 0 dropped pairs, the EP bodies counted (none and
    the dense path counted at model axis 1); at bf16 and the config's
    capacity factor 1.25, finite logits of the right shape.  Printed for
    DeepSeek-V2: prefill seconds, decode tokens/s, peak memory per rank,
    dropped pairs (each counted once over the mesh), one decode step's
    device ms and NCCL ms per rank (by kernel name, torch.profiler), the
    next decode step's collective bytes per rank (OpStats), the bytes one
    prefill all_to_all moves out of a rank (cap1 x d x 2 B x n_shards)."""
    t_phase = time.perf_counter()
    world = min(torch.cuda.device_count(), 4)
    os.makedirs("build", exist_ok=True)
    archs = [(LM_MESH_ARCH, LM_MESH_LAYERS, 60)]
    if world > 1:
        archs.append((LM_MESH_GQA, LM_MESH_GQA_LAYERS, 36))
    refs = {}
    try:
        for arch, layers, depth in archs:
            refs[arch] = os.path.join("build", f"lm_mesh_ref_{arch}_{os.getpid()}.npz")
            n_params, ref_s, ref_peak = lm_mesh_reference(refs[arch], arch, layers)
            print(f"[lm-mesh] {arch} at published width, {layers} of {depth} "
                  f"layers: {n_params / 1e9:.3f}B parameters; no-mesh float32 "
                  f"run on card 0 (prefill {LM_MESH_B} x {LM_MESH_S}, "
                  f"{LM_MESH_STEPS} greedy steps) {ref_s:.1f} s, peak "
                  f"{ref_peak:.3f} GiB")
        runs = [lm_mesh_run(LM_MESH_ARCH, shape, LM_MESH_LAYERS, ("seq",), True)
                for shape in lm_mesh_meshes(world)]
        if world > 1:
            runs += [lm_mesh_run(LM_MESH_GQA, shape, LM_MESH_GQA_LAYERS,
                                 ("seq", "heads"), False)
                     for shape in lm_mesh_meshes(world)]
        report = lm_mesh_spawn({"refs": refs, "runs": runs}, world, "smoke")
    finally:
        for path in refs.values():
            if os.path.exists(path):
                os.remove(path)
    lm_mesh_print(report)
    # reduced Whisper-small through the encoder's and cross attention's
    # split regions, under both rule cases
    split = lm_mesh_spawn({"runs": lm_mesh_split_runs(world, ("whisper",),
                                                      reduced=True),
                           "build": "build"}, world, "split",
                          target=_lm_mesh_train_rank)
    lm_mesh_train_print(split)
    print(f"[lm-mesh] world {world}: {time.perf_counter() - t_phase:.1f} s in all")
    return report


# The split runs (tools/lm_mesh.py --recurrent, --whisper): each model on
# each mesh of the cards against its no-mesh run at float32, served (the
# [lm-mesh] prompt and decode steps, bound LM_MESH_REL) and trained (one
# [lm-mesh-train] parity run, remat "dots", its bounds).  RecurrentGemma-2B
# (one (R, R, A) group and one R tail) and xLSTM-350M (two (mLSTM, sLSTM)
# groups) at published width, 4 layers; reduced xLSTM with 2 and 3 heads of
# 16 at (1, N), where heads straddle ranks; Whisper-small at published width,
# 2 decoder and 2 encoder layers, under the default rules and with the
# vocabulary replicated (the dry run's rule for its 51,865 tokens).
LM_SPLIT_RECURRENT = (("recurrentgemma-2b", 4), ("xlstm-350m", 4))
LM_SPLIT_HEADS = (2, 3)
LM_SPLIT_WHISPER_LAYERS = 2


def lm_mesh_split_runs(world, which, reduced=False):
    """The split runs of ``which`` ("recurrent", "whisper") on ``world``
    ranks; ``reduced``: Whisper's serving runs only, at its reduced
    config.  A run whose spec has ``float64`` set is printed as run in
    float64 (tools/float64_witness.py)."""
    meshes = lm_mesh_meshes(world)
    runs = []

    def both(arch, shape, layers, **kw):
        return [lm_mesh_train_run("serve", arch, shape, layers, **kw),
                lm_mesh_train_run("parity", arch, shape, layers,
                                  remats=["dots"], profile=True, **kw)]
    if "recurrent" in which:
        for arch, layers in LM_SPLIT_RECURRENT:
            for shape in meshes:
                runs += both(arch, shape, layers)
        for h in LM_SPLIT_HEADS:
            runs += both("xlstm-350m", (1, world), 2, reduced=True, heads=h)
    if "whisper" in which:
        for rules in (None, "vocab"):
            for shape in meshes:
                if reduced:
                    runs.append(lm_mesh_train_run(
                        "serve", "whisper-small", shape, 1, reduced=True,
                        rules=rules))
                else:
                    runs += both("whisper-small", shape,
                                 LM_SPLIT_WHISPER_LAYERS, rules=rules)
    return runs

# [lm-mesh-train]: the LM plane's training on a mesh.  (a) Qwen3-4B
# at published width, 4 of 36 layers (1.182B parameters), float32 compute
# with TF32 off: two make_train_step steps on the mesh, remat "dots" and
# off, against the no-mesh steps on the same card.  (b) DeepSeek-V2-236B at
# published width, LM_MESH_TRAIN_MOE_LAYERS of 60 layers (the depth one card
# holds with a fifth free, tools/lm_mesh.py --train-depth), seeded bf16
# weights, int8 moments, capacity factor 1.25: two steps, then a sharded
# save and restore.  One card runs both at (1, 1) through a one-rank NCCL
# group; tools/lm_mesh.py --train runs the four-card runs.
LM_MESH_TRAIN_B, LM_MESH_TRAIN_S = 8, 128
LM_MESH_TRAIN_REL_LOSS = 1e-5   # mesh vs no mesh, each step's loss
LM_MESH_TRAIN_REL = 1e-4        # every parameter and moment leaf, of its max
LM_MESH_TRAIN_MOE_LAYERS = 1
LM_MESH_TRAIN_STEPS = 2


def lm_mesh_train_batch(cfg):
    """The seeded batch every rank draws alike: tokens and labels (B, S),
    and an encoder-decoder's input frames, standard normal."""
    rng = np.random.default_rng(SEED)
    shape = (LM_MESH_TRAIN_B, LM_MESH_TRAIN_S)
    batch = {k: rng.integers(0, cfg.vocab_size, shape) for k in
             ("tokens", "labels")}
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (LM_MESH_TRAIN_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def lm_mesh_train_run(kind, arch, shape, layers, **kw):
    """One run of ``_lm_mesh_train_rank``: ``kind`` 'parity' (mesh steps
    against no-mesh steps), 'moe' (bf16 steps with int8 moments; ``save``:
    a sharded save and restore, ``profile``: one more step's device ms) or
    'loop' (train_loop(mesh=) at full depth, then timed steps)."""
    return dict(kind=kind, arch=arch, shape=list(shape), layers=layers, **kw)


def _timed_steps(step, state, batch, n):
    """``n`` steps, each timed on the host clock to a synchronize (with a
    barrier first, so a rank waits for the others before its clock
    starts); returns (state, losses, seconds)."""
    import torch.distributed as dist
    losses, secs = [], []
    for _ in range(n):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, losses, secs


def _profiled_ms(fn):
    """Device ms and NCCL ms of ``fn()`` on this rank (torch.profiler,
    kernels by name); returns (its result, (device ms, NCCL ms))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0
            and not ev.key.startswith(("Memcpy", "Memset"))]
    return out, (sum(ev.self_device_time_total for ev in kern) / 1e3,
                 sum(ev.self_device_time_total for ev in kern
                     if "nccl" in ev.key.lower()) / 1e3)


def _step_device_ms(step, state, batch):
    """Device ms and NCCL ms of one more step on this rank."""
    (state, _), ms = _profiled_ms(lambda: step(state, batch))
    return state, ms


def _collective_bytes(fn):
    """The output-buffer bytes of each collective kind ``fn()`` issues on
    this rank, as ``OpStats`` counts them."""
    from repro_torch.roofline.op_stats import OpStats
    with OpStats() as st:
        fn()
    torch.cuda.synchronize()
    return st.stats()["collective_bytes"]


def _coll_line(per_rank):
    """Each rank's collective bytes in all (its all-gather bytes)."""
    return (f"{[int(sum(c.values())) for c in per_rank]} (all-gather "
            f"{[int(c['all-gather']) for c in per_rank]})")


def _step_profile(step, state, batch):
    """Two more steps on this rank: the first's device and NCCL ms
    (:func:`_step_device_ms`), the second's collective bytes
    (:func:`_collective_bytes`).  Returns (state, ms pair, bytes)."""
    state, ms = _step_device_ms(step, state, batch)
    box = [state]

    def one():
        box[0], _ = step(box[0], batch)
    coll = _collective_bytes(one)
    return box[0], ms, coll


def _leaf_errors(state, want, mesh):
    """The worst rel error (of each leaf's max over the whole tensor) of the
    mesh state's parameter and moment leaves against the no-mesh state's,
    each rank comparing its shards with the same slices of its own no-mesh
    copy; max over ranks (a collective).  Returns (error, leaf)."""
    import torch.distributed as dist
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.sharding import place
    mine = tree_paths({"params": state["params"], "m": state["opt"]["m"],
                       "v": state["opt"]["v"]})
    full = tree_paths({"params": want["params"], "m": want["opt"]["m"],
                       "v": want["opt"]["v"]})
    worst, name = 0.0, ""
    for k, g in mine.items():
        w = full[k].detach()
        ref = place(w, g.device_mesh, g.placements).to_local()
        err = float((g.detach().to_local().float() - ref.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30)) if ref.numel() else 0.0
        if err > worst:
            worst, name = err, k
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (worst, name))
    return max(out)


def _lm_mesh_train_parity(spec, mesh):
    """Qwen3-4B (``spec['layers']`` deep, float32 compute) trained
    LM_MESH_TRAIN_STEPS steps on ``mesh`` with each remat of ``spec`` and
    without a mesh on this rank's card, from one seed; with ``profile``,
    :func:`_step_profile` after each remat's steps."""
    from repro_torch.models import Model, transformer
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    cfg = lm_mesh_spec_config(spec)
    batch = lm_mesh_train_batch(cfg)
    oc = AdamWConfig(**LM_ADAMW)
    transformer.set_remat_policy("dots")
    free_device_memory()
    plain = Model.init(cfg, cuda_gen(), device="cuda")
    want = init_train_state(plain, oc)
    step = make_train_step(plain, oc, microbatches=2, remat=True)
    want, want_losses, plain_s = _timed_steps(step, want, batch,
                                              LM_MESH_TRAIN_STEPS)
    out = {"n_params": sum(p.numel() for p in plain.parameters()),
           "plain_losses": want_losses, "plain_s": plain_s, "remat": {}}
    for remat in spec["remats"]:
        model = Model.init(cfg, cuda_gen(), mesh=mesh)
        state = init_train_state(model, oc)
        step = _in_rules(make_train_step(model, oc, microbatches=2,
                                         remat=remat != "off"), mesh, spec)
        state, losses, secs = _timed_steps(step, state, batch,
                                           LM_MESH_TRAIN_STEPS)
        err, leaf = _leaf_errors(state, want, mesh)
        out["remat"][remat] = {
            "losses": losses, "s": secs, "leaf_rel": err, "leaf": leaf,
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, want_losses))}
        if spec.get("profile"):
            _, out["remat"][remat]["device_ms"], \
                out["remat"][remat]["coll_bytes"] = _step_profile(
                    step, state, batch)
        del model, state, step
        free_device_memory()
    del plain, want
    free_device_memory()
    return out


# Rule cases a run may name (``spec['rules']``): the dry run's for a
# vocabulary that the model axis does not divide (Whisper's 51,865).
LM_MESH_RULES = {"vocab": {"vocab": None}}


def lm_mesh_spec_config(spec, compute_dtype="float32"):
    """The config of a 'parity' or 'serve' run (:func:`lm_mesh_config`)."""
    return lm_mesh_config(spec["layers"], compute_dtype, LM_MESH_PARITY_CF,
                          spec["arch"], spec.get("reduced", False),
                          spec.get("heads"))


def _in_rules(fn, mesh, spec):
    """``fn`` run inside ``sharding_rules(mesh, ...)`` of the spec's rule
    case (the model's own default rules where it names none)."""
    from repro_torch.models.sharding import sharding_rules
    rules = LM_MESH_RULES.get(spec.get("rules"))
    if rules is None:
        return fn

    def run(*args):
        with sharding_rules(mesh, rules):
            return fn(*args)
    return run


def _lm_mesh_serve_parity(spec, mesh):
    """The config of ``spec`` at float32 compute prefilled (LM_MESH_B x
    LM_MESH_S) and decoded LM_MESH_STEPS steps on ``mesh`` under the
    spec's rule case, against the no-mesh run on card 0 (rank 0 runs it
    and sends its logits and greedy tokens; the mesh run is fed those
    tokens); then one more decode step's device and NCCL ms and the next
    step's collective bytes on this rank."""
    import torch.distributed as dist
    from repro_torch.models import Model
    cfg = lm_mesh_spec_config(spec)
    prompt = lm_mesh_prompt(cfg)
    box = [None]
    if dist.get_rank() == 0:
        free_device_memory()
        plain = Model.init(cfg, cuda_gen(), device="cuda")
        logits, dec, toks, _ = lm_mesh_serve(plain, prompt, LM_MESH_STEPS)
        box[0] = {"prefill": logits.float().cpu().numpy(),
                  "decode": [d.float().cpu().numpy() for d in dec],
                  "tokens": toks}
        del plain, logits, dec
        free_device_memory()
    dist.broadcast_object_list(box, src=0)
    ref = box[0]
    model = Model.init(cfg, cuda_gen(), mesh=mesh)
    serve = _in_rules(lm_mesh_serve, mesh, spec)
    decode = _in_rules(model.decode_step, mesh, spec)
    logits, dec, _, caches = serve(model, prompt, LM_MESH_STEPS,
                                   ref["tokens"], 2)
    errs = [rel_err(logits.float().cpu(), torch.as_tensor(ref["prefill"]))]
    errs += [rel_err(d.float().cpu(), torch.as_tensor(ref["decode"][i]))
             for i, d in enumerate(dec)]
    pos = LM_MESH_S + LM_MESH_STEPS
    tok = torch.as_tensor(ref["tokens"][-1], device="cuda")
    (cur, caches), ms = _profiled_ms(lambda: decode(tok, caches, pos))
    coll = _collective_bytes(lambda: decode(tok, caches, pos + 1))
    out = {"n_params": sum(p.numel() for p in model.parameters()),
           "prefill_rel": errs[0], "decode_rel": max(errs[1:]),
           "device_ms": ms, "coll_bytes": coll,
           "finite": bool(torch.isfinite(cur).all())}
    del model, logits, dec, caches, cur
    free_device_memory()
    return out


def _lm_mesh_train_moe(spec, mesh, shape, build):
    """DeepSeek-V2 (``spec['layers']`` deep, bf16, int8 moments, capacity
    factor 1.25) trained on ``mesh``: step seconds, losses, peak memory;
    with ``profile`` one more step's device and NCCL ms and the collective
    bytes of the next (:func:`_step_profile`); with ``save`` the
    state of layer group 0 but its routed experts saved sharded (rank 0
    writes) and restored bit for bit."""
    import torch.distributed as dist
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import init_train_state
    cfg = lm_mesh_config(spec["layers"], arch=spec["arch"])
    batch = lm_mesh_train_batch(cfg)
    oc = AdamWConfig(lr=1e-3, warmup_steps=20, int8_states=True)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model.init(cfg, cuda_gen(), mesh=mesh)
    state = init_train_state(model, oc)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "n_params": sum(p.numel() for p in model.parameters())}
    step = make_train_step(model, oc, microbatches=2, remat=False)
    state, out["losses"], out["s"] = _timed_steps(step, state, batch,
                                                  LM_MESH_TRAIN_STEPS)
    if spec.get("profile"):
        state, out["device_ms"], out["coll_bytes"] = _step_profile(
            step, state, batch)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if spec.get("save"):
        def part(tree):
            g = dict(tree["blocks"][0]["0:mla"])
            g["ffn"] = {k: v for k, v in g["ffn"].items()
                        if k not in ("w_g", "w_u", "w_o")}
            return {"group0": g, "final_norm": tree["final_norm"]}
        sub = {"params": part(state["params"]),
               "opt": {"m": part(state["opt"]["m"]),
                       "v": part(state["opt"]["v"])}}
        ckpt = os.path.join(build, f"lm_mesh_train_ckpt_{os.getpid()}")
        mgr = CheckpointManager(ckpt, keep=1)
        t0 = time.perf_counter()
        mgr.save(1, sub)
        back, _ = mgr.restore(tree_map(torch.zeros_like, sub))
        out["save_restore_s"] = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(back), tree_leaves(sub), strict=True))
        out["saved_params"] = sum(b.numel() for b, _ in pairs)
        out["restore_equal"] = all(
            a.dtype == b.dtype and tuple(a.placements) == tuple(b.placements)
            and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
        dist.barrier()
        if dist.get_rank() == 0:
            import shutil
            shutil.rmtree(ckpt, ignore_errors=True)
    nd, n = shape
    t = LM_MESH_TRAIN_B // 2 * LM_MESH_TRAIN_S // n    # a microbatch's tokens
    cap1 = math.ceil(t * cfg.moe.top_k / n * cfg.moe.capacity_factor)
    out["a2a_bytes"] = cap1 * cfg.d_model * 2 * n if n > 1 else 0
    # rows out and back, forward and backward, per layer and microbatch
    out["a2a_per_step"] = 4 * spec["layers"] * 2 if n > 1 else 0
    out["finite"] = all(math.isfinite(v) for v in out["losses"])
    del model, state, step
    free_device_memory()
    return out


def _lm_mesh_train_loop(spec, mesh):
    """Qwen3-4B at published width and depth: train_loop(mesh=) for
    LM_MESH_TRAIN_STEPS steps (remat off, as the launcher), then the same
    step on a fresh model timed and profiled."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    cfg = lm_mesh_config(spec["layers"], "bfloat16", arch=spec["arch"])
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_loop(cfg, steps=LM_MESH_TRAIN_STEPS,
                        batch_size=LM_MESH_TRAIN_B, seq_len=LM_MESH_TRAIN_S,
                        ckpt_dir=None, resume=False, dp=None, microbatches=2,
                        ckpt_every=0, mesh=mesh, log_every=1)[1]
    out = {"loop_losses": losses, "loop_s": time.perf_counter() - t0,
           "loop_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, cuda_gen(), mesh=mesh)
    out["n_params"] = sum(p.numel() for p in model.parameters())
    oc = AdamWConfig(lr=1e-3, warmup_steps=20)
    state = init_train_state(model, oc)
    step = make_train_step(model, oc, microbatches=2, remat=False)
    batch = lm_mesh_train_batch(cfg)
    state, out["losses"], out["s"] = _timed_steps(step, state, batch,
                                                  LM_MESH_TRAIN_STEPS + 1)
    state, out["device_ms"], out["coll_bytes"] = _step_profile(
        step, state, batch)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["finite"] = all(math.isfinite(v) for v in out["losses"] + losses)
    del model, state, step
    free_device_memory()
    return out


def _lm_mesh_train_rank(rank, world, store, job, out_path):
    """One NCCL rank of [lm-mesh-train] (spawned): each run of the job on
    its mesh; rank 0 writes every rank's numbers to ``out_path``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    nccl_rank(rank, world, store, 300)
    report = {"world": world, "runs": []}
    try:
        for spec in job["runs"]:
            shape = tuple(spec["shape"])
            mesh = make_host_mesh("cuda", shape)
            t0 = time.perf_counter()
            if spec["kind"] in ("parity", "serve"):
                run = (_lm_mesh_train_parity if spec["kind"] == "parity"
                       else _lm_mesh_serve_parity)
                res = run(spec, mesh)
            elif spec["kind"] == "moe":
                res = _lm_mesh_train_moe(spec, mesh, shape, job["build"])
            else:
                res = _lm_mesh_train_loop(spec, mesh)
            res["run_s"] = time.perf_counter() - t0
            res["card_gib"] = torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory / 2**30
            ranks = [None] * world
            dist.all_gather_object(ranks, res)
            report["runs"].append(dict(spec, ranks=ranks))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def lm_mesh_train_print(report, gates=True):
    """Print a report of ``_lm_mesh_train_rank`` and hold it to the gates:
    every run is printed, then the failed gates raise together."""
    world = report["world"]
    failed = []

    def check(ok, what):
        if gates and not ok:
            failed.append(what)
    for run in report["runs"]:
        r0, ranks = run["ranks"][0], run["ranks"]
        what = (f"reduced, {run['heads']} heads" if run.get("heads") else
                "reduced" if run.get("reduced") else f"{run['layers']} layers")
        tag = (f"[lm-mesh{'' if run['kind'] == 'serve' else '-train'}] world "
               f"{world} mesh {tuple(run['shape'])} {run['arch']} {what}"
               + (f" rules '{run['rules']}'" if run.get("rules") else "")
               + (" in float64" if run.get("float64") else ""))
        if run["kind"] == "serve":
            dt = "float64" if run.get("float64") else "float32"
            print(f"{tag} ({r0['n_params'] / 1e9:.4f}B parameters, {dt}, "
                  f"{LM_MESH_B} x {LM_MESH_S} prompt, {LM_MESH_STEPS} decode "
                  f"steps): prefill rel {r0['prefill_rel']:.3e}, decode rel "
                  f"{r0['decode_rel']:.3e} (bound {LM_MESH_REL}) against the "
                  f"no-mesh run on card 0; one decode step's device ms per "
                  f"rank {[round(r['device_ms'][0], 3) for r in ranks]}, of it "
                  f"NCCL {[round(r['device_ms'][1], 3) for r in ranks]}; the "
                  f"next step's collective bytes per rank "
                  f"{_coll_line([r['coll_bytes'] for r in ranks])}")
            check(r0["prefill_rel"] < LM_MESH_REL
                  and r0["decode_rel"] < LM_MESH_REL, (tag, r0))
            check(all(r["finite"] for r in ranks), (tag, "not finite"))
            continue
        if run["kind"] == "parity":
            dt = "float64" if run.get("float64") else "float32"
            print(f"{tag} ({r0['n_params'] / 1e9:.3f}B parameters, {dt} "
                  f"compute, TF32 off, {LM_MESH_TRAIN_B} x {LM_MESH_TRAIN_S} "
                  f"tokens in 2 microbatches, AdamW {dt} moments): no-mesh "
                  f"losses {r0['plain_losses']}, steps "
                  f"{[round(x, 4) for x in r0['plain_s']]} s")
            for remat, res in r0["remat"].items():
                print(f"{tag} remat '{remat}': losses {res['losses']}, steps "
                      f"{[round(x, 4) for x in res['s']]} s; loss rel "
                      f"{res['loss_rel']:.3e} (bound {LM_MESH_TRAIN_REL_LOSS}); "
                      f"worst parameter/moment leaf rel {res['leaf_rel']:.3e} "
                      f"({res['leaf']}; bound {LM_MESH_TRAIN_REL})")
                if "device_ms" in res:
                    per = [r["remat"][remat] for r in ranks]
                    print(f"{tag} remat '{remat}': one step's device ms per "
                          f"rank {[round(p['device_ms'][0], 2) for p in per]},"
                          f" of it NCCL "
                          f"{[round(p['device_ms'][1], 2) for p in per]}; the "
                          f"next step's collective bytes per rank "
                          f"{_coll_line([p['coll_bytes'] for p in per])}")
                check(res["loss_rel"] < LM_MESH_TRAIN_REL_LOSS
                      and res["leaf_rel"] < LM_MESH_TRAIN_REL,
                      (tag, remat, res["loss_rel"], res["leaf_rel"],
                       res["leaf"]))
            continue
        tokens = LM_MESH_TRAIN_B * LM_MESH_TRAIN_S
        secs = [max(r["s"][i] for r in ranks) for i in range(len(r0["s"]))]
        line = (f"{tag} ({r0['n_params'] / 1e9:.3f}B parameters, "
                f"{LM_MESH_TRAIN_B} x {LM_MESH_TRAIN_S} tokens in 2 "
                f"microbatches, remat off"
                + (", bf16, int8 moments, cf "
                   f"{lm_mesh_config(1).moe.capacity_factor}"
                   if run["kind"] == "moe" else ", float32 moments") + "): "
                f"losses {r0['losses']}; step s (slowest rank) "
                f"{[round(x, 4) for x in secs]}, {tokens / secs[-1]:.1f} "
                f"tokens/s at the last; peak GiB per rank "
                f"{[round(r['peak_gib'], 3) for r in ranks]} of "
                f"{r0['card_gib']:.1f}")
        if "device_ms" in r0:
            line += (f"; one step's device ms per rank "
                     f"{[round(r['device_ms'][0], 2) for r in ranks]}, of it "
                     f"NCCL {[round(r['device_ms'][1], 2) for r in ranks]}; "
                     f"the next step's collective bytes per rank "
                     f"{_coll_line([r['coll_bytes'] for r in ranks])}")
        if run["kind"] == "moe" and r0["a2a_bytes"]:
            line += (f"; all_to_all bytes out of a rank per dispatch "
                     f"{r0['a2a_bytes']:,}, {r0['a2a_per_step']} activation "
                     f"all_to_alls a step")
        if run["kind"] == "loop":
            line += (f"; train_loop(mesh=) losses {r0['loop_losses']} in "
                     f"{r0['loop_s']:.1f} s, peak GiB per rank "
                     f"{[round(r['loop_peak_gib'], 3) for r in ranks]}")
        print(line)
        if "restore_equal" in r0:
            print(f"{tag}: sharded save and restore of layer group 0's state "
                  f"but its routed experts ({r0['saved_params'] / 1e6:.1f}M "
                  f"values: bf16 parameters, int8 q, float32 s) "
                  f"{r0['save_restore_s']:.2f} s, bit-equal "
                  f"{all(r['restore_equal'] for r in ranks)}")
        check(all(r["finite"] for r in ranks), (tag, "not finite"))
        if "restore_equal" in r0:
            check(all(r["restore_equal"] for r in ranks),
                  (tag, "restore not equal"))
    if failed:
        raise AssertionError(f"[lm-mesh] gates failed: {failed}")


def lm_mesh_train_one_card_runs(moe_layers=LM_MESH_TRAIN_MOE_LAYERS):
    """The (1, 1) runs of [lm-mesh-train]."""
    return [lm_mesh_train_run("parity", LM_MESH_GQA, (1, 1),
                              LM_MESH_GQA_LAYERS, remats=["dots", "off"]),
            lm_mesh_train_run("moe", LM_MESH_ARCH, (1, 1), moe_layers,
                              save=True)]


def phase_lm_mesh_train(card):
    """[lm-mesh-train] the LM plane's training on a mesh (Model.loss_fn,
    make_train_step, AdamW with int8 moments on DTensors, sharded
    checkpoints) at (1, 1) through a one-rank NCCL group (a FileStore under
    build/, NCCL_SOCKET_IFNAME=lo).

    (a) Qwen3-4B at published width, 4 of 36 layers, float32 compute with
    TF32 off, 8 x 128 tokens in 2 microbatches: two steps on the mesh with
    remat "dots" and with remat off, against two no-mesh steps on the same
    card from the same seed.  Gates: each step's loss within rel 1e-5, every
    parameter and moment leaf within rel 1e-4 of its max.  (b)
    DeepSeek-V2-236B at published width, LM_MESH_TRAIN_MOE_LAYERS of 60
    layers, seeded bf16 weights, int8 moments, capacity factor 1.25 (the
    model axis is 1, so its MoE runs the dense path): two steps, their
    seconds and peak memory; gates: finite losses, and layer group 0's
    state but its routed experts saved sharded and restored bit-equal.
    The four-card runs: tools/lm_mesh.py --train."""
    t_phase = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    report = lm_mesh_spawn({"runs": lm_mesh_train_one_card_runs(),
                            "build": "build"}, 1, "train",
                           target=_lm_mesh_train_rank)
    lm_mesh_train_print(report)
    print(f"[lm-mesh-train] {time.perf_counter() - t_phase:.1f} s in all")
    return report


# ---------------------------------------------------------------------------
# [lm-mesh-dp]: DP-SGD on a mesh.  Each (pod, data) coordinate clips its own
# examples one at a time on its model ranks (repro_torch.train.dp), the
# clipped sums are added over the batch axes, and the noise is drawn at each
# leaf's global shape, so a mesh step equals the one-card DP step from the
# same generator state.  min(cards, 4) NCCL ranks, spawned as
# [lm-mesh-train] spawns them: on one card the mesh is (1, 1).
LM_DP_B, LM_DP_S = 4, 64
LM_DP_CLIP = 1e-2          # below the examples' norms: every one is clipped
LM_DP_REL = 1e-5           # loss and every leaf (of its max), mesh vs one card
LM_DP_NO_DROPS, LM_DP_DROPS = 100.0, 1.0   # reduced DeepSeek-V2's capacity
LM_DP_FULL_B, LM_DP_FULL_S, LM_DP_FULL_STEPS = 4, 128, 2
LM_DP_ONE_CARD_LAYERS = 8  # Qwen3-4B's depth cut for one card's DP run
LM_DP_REAL_STEP = (4, 32)  # B, S of the fake-against-real train step


def lm_dp_batch(cfg, B, S, seed=SEED):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                      device="cuda"),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                      device="cuda")}


def lm_dp_reduced(arch, cf=None):
    """``arch``'s reduced config (float32), at capacity factor ``cf``."""
    import dataclasses
    from repro_torch.configs import load_all, shapes
    load_all()
    cfg = shapes.reduced_config(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _aux_free(model):
    from repro_torch.models.layers import tree_paths
    return lambda p, b: torch.func.functional_call(
        model, tree_paths(p, "."), (b,), {"aux_weight": 0.0})


def _tree_errors(got, want, mesh):
    """The worst rel error (of each leaf's max) of a DTensor tree against a
    plain tree on this rank's card, each rank comparing its shards; max over
    ranks (a collective).  Returns (error, leaf)."""
    import torch.distributed as dist
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.sharding import place
    full = tree_paths(want)
    worst, name = 0.0, ""
    for k, g in tree_paths(got).items():
        w = full[k].detach()
        ref = place(w, g.device_mesh, g.placements).to_local()
        err = float((g.detach().to_local().float() - ref.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30)) if ref.numel() else 0.0
        if err > worst:
            worst, name = err, k
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (worst, name))
    return max(out)


def _lm_dp_step_parity(mesh):
    """Qwen3-4B at published width, LM_MESH_GQA_LAYERS deep, float32: one
    DP-SGD step (2 microbatches, clip LM_DP_CLIP, noise 1) on ``mesh``
    against the same step on this rank's card without a mesh, from one
    generator state."""
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, DPSGDConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    cfg = lm_mesh_config(LM_MESH_GQA_LAYERS, "float32", arch=LM_MESH_GQA)
    batch = lm_dp_batch(cfg, LM_DP_B, LM_DP_S)
    oc = AdamWConfig(**LM_ADAMW)
    dp = DPSGDConfig(clip_norm=LM_DP_CLIP)
    free_device_memory()
    plain = Model.init(cfg, cuda_gen(), device="cuda")
    want, met = make_train_step(plain, oc, microbatches=2, dp=dp)(
        init_train_state(plain, oc), batch)
    want_loss = float(met["loss"])
    want = {"params": want["params"], "m": want["opt"]["m"],
            "v": want["opt"]["v"]}
    del plain
    free_device_memory()
    model = Model.init(cfg, cuda_gen(), mesh=mesh)
    step = make_train_step(model, oc, microbatches=2, dp=dp)
    state, losses, secs = _timed_steps(step, init_train_state(model, oc),
                                       batch, 1)
    err, leaf = _tree_errors({"params": state["params"],
                              "m": state["opt"]["m"], "v": state["opt"]["v"]},
                             want, mesh)
    out = {"n_params": sum(p.numel() for p in model.parameters()),
           "loss": losses[0], "plain_loss": want_loss, "s": secs[0],
           "loss_rel": abs(losses[0] - want_loss) / abs(want_loss),
           "leaf_rel": err, "leaf": leaf}
    del model, state, step, want
    free_device_memory()
    return out


def _lm_dp_clip_parity(mesh, cf, against="card"):
    """Reduced DeepSeek-V2 (float32, capacity factor ``cf``): the mesh's
    clipped mean (auxiliary loss off) and its dropped pairs, against this
    rank's one-card result (``against`` "card"), or against each (pod,
    data) coordinate's example mesh clipping the whole batch on its own
    ("example_mesh": no batch axis, what the mesh run must add up to when
    each example is routed alone), or against nothing (None)."""
    from repro_torch.models import Model, moe
    from repro_torch.train.dp import (_on_example_mesh, example_mesh,
                                      per_example_clipped_grad)
    from repro_torch.models.layers import tree_map
    cfg = lm_dp_reduced(LM_MESH_ARCH, cf)
    batch = lm_dp_batch(cfg, LM_DP_B, LM_DP_S)
    model = Model.init(cfg, cuda_gen(), mesh=mesh)
    moe.reset_moe_stats()
    got = per_example_clipped_grad(_aux_free(model), model.tree(), batch,
                                   LM_DP_CLIP)
    dropped = moe.moe_stats()["dropped"]
    if against is None:
        return {"dropped": int(dropped)}
    if against == "example_mesh":
        sub = example_mesh(mesh)
        ex = tree_map(lambda p: _on_example_mesh(p, sub).detach(), model.tree())
        alone = per_example_clipped_grad(_aux_free(model), ex, batch,
                                         LM_DP_CLIP)
        want = tree_map(lambda g: g.full_tensor(), alone)
    else:
        plain = Model.init(cfg, cuda_gen(), device="cuda")
        want = per_example_clipped_grad(_aux_free(plain), plain.tree(),
                                        batch, LM_DP_CLIP)
    err, leaf = _tree_errors(got, want, mesh)
    return {"leaf_rel": err, "leaf": leaf, "dropped": int(dropped)}


def _lm_dp_full(world, mesh):
    """Qwen3-4B at published width, float32 (full depth on four cards,
    LM_DP_ONE_CARD_LAYERS on one), trained by train_loop(dp=DPSGDConfig(),
    mesh=) for LM_DP_FULL_STEPS steps with an accountant, then one more
    DP step timed."""
    from repro_torch.launch.train import train_loop
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train import DPSGDConfig
    from repro_torch.train.dp import DPSGDAccountant
    layers = 36 if world >= 4 else LM_DP_ONE_CARD_LAYERS
    cfg = lm_mesh_config(layers, "float32", arch=LM_MESH_GQA)
    dp = DPSGDConfig()
    acct = DPSGDAccountant(dp)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = train_loop(
        cfg, steps=LM_DP_FULL_STEPS, batch_size=LM_DP_FULL_B,
        seq_len=LM_DP_FULL_S, ckpt_dir=None, resume=False, dp=dp,
        microbatches=2, ckpt_every=0, mesh=mesh, log_every=1, accountant=acct)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    del state
    free_device_memory()
    return {"layers": layers, "n_params": n_params, "losses": losses,
            "loop_s": loop_s, "step_s": loop_s / LM_DP_FULL_STEPS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "report": acct.report(),
            "finite": all(math.isfinite(v) for v in losses)}


def _lm_dp_rank(rank, world, store, job, out_path):
    """One NCCL rank of [lm-mesh-dp] (spawned): the parity runs on each
    mesh, the full-width run, and the counters of a real train step; rank 0
    writes every rank's numbers to ``out_path``."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import count_real_train_step
    from repro_torch.launch.mesh import make_host_mesh
    nccl_rank(rank, world, store, 600)
    report = {"world": world, "meshes": {}}
    try:
        for shape in lm_mesh_meshes(world):
            mesh = make_host_mesh("cuda", shape)
            t0 = time.perf_counter()
            res = {"qwen_step": _lm_dp_step_parity(mesh),
                   "moe_clip": _lm_dp_clip_parity(mesh, LM_DP_NO_DROPS)}
            if mesh.size(1) > 1:     # an expert axis: capacity drops
                res["moe_drops"] = _lm_dp_clip_parity(
                    mesh, LM_DP_DROPS,
                    "example_mesh" if mesh.size(0) > 1 else None)
            res["s"] = time.perf_counter() - t0
            ranks = [None] * world
            dist.all_gather_object(ranks, res)
            report["meshes"][str(shape)] = ranks
        mesh = make_host_mesh("cuda", (1, world))
        res = _lm_dp_full(world, mesh)
        ranks = [None] * world
        dist.all_gather_object(ranks, res)
        report["full"] = ranks
        report["real_counts"] = count_real_train_step(
            lm_dp_reduced(LM_MESH_GQA), *LM_DP_REAL_STEP, mesh,
            microbatches=2)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


_FAKE_COUNTS = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import load_all, shapes
from repro_torch.launch.dryrun import count_step, start_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import DEFAULT_RULES
load_all()
start_fake_group({world})
mesh = make_mesh((1, {world}), ("data", "model"), "cuda")
rec = count_step(shapes.reduced_config({arch!r}), "train", {B}, {S}, mesh,
                 DEFAULT_RULES, microbatches=2, device="cuda")
print(json.dumps(rec["op_stats"]))
"""


def lm_dp_fake_counts(world):
    """The fake step's counters on a fake (1, world) mesh, in a child
    process (its own fake process group; fake CUDA tensors)."""
    code = _FAKE_COUNTS.format(
        src=os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"),
        world=world, arch=LM_MESH_GQA, B=LM_DP_REAL_STEP[0],
        S=LM_DP_REAL_STEP[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"[lm-mesh-dp] the fake count failed: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def lm_dp_print(report, fake, gates=True):
    """Print a report of ``_lm_dp_rank`` and hold it to the gates."""
    world = report["world"]
    for shape, ranks in report["meshes"].items():
        r0 = ranks[0]
        q = r0["qwen_step"]
        tag = f"[lm-mesh-dp] world {world} mesh {shape}"
        print(f"{tag} {LM_MESH_GQA} {LM_MESH_GQA_LAYERS} layers "
              f"({q['n_params'] / 1e9:.3f}B parameters, float32, TF32 off, "
              f"{LM_DP_B} x {LM_DP_S} tokens in 2 microbatches, clip "
              f"{LM_DP_CLIP}, noise 1): one DP-SGD step {q['s']:.3f} s; loss "
              f"{q['loss']!r} against the one-card step's {q['plain_loss']!r}, "
              f"rel {q['loss_rel']:.3e}; worst parameter/moment leaf rel "
              f"{q['leaf_rel']:.3e} ({q['leaf']}; bound {LM_DP_REL})")
        m = r0["moe_clip"]
        print(f"{tag} reduced {LM_MESH_ARCH} (capacity factor "
              f"{LM_DP_NO_DROPS}, auxiliary loss off): clipped mean against "
              f"the one card's, worst leaf rel {m['leaf_rel']:.3e} "
              f"({m['leaf']}); dropped pairs "
              f"{sum(r['moe_clip']['dropped'] for r in ranks)}")
        if gates:
            assert q["loss_rel"] < LM_DP_REL and q["leaf_rel"] < LM_DP_REL, q
            assert m["leaf_rel"] < LM_DP_REL, m
        if "moe_drops" in r0:
            d = r0["moe_drops"]
            drops = sum(r["moe_drops"]["dropped"] for r in ranks)
            line = (f"{tag} reduced {LM_MESH_ARCH} (capacity factor "
                    f"{LM_DP_DROPS}): {drops} dropped pairs")
            if "leaf_rel" in d:
                line += (f"; the clipped mean against each example mesh "
                         f"clipping the whole batch alone, worst leaf rel "
                         f"{d['leaf_rel']:.3e} ({d['leaf']})")
            print(line)
            if gates:
                assert drops > 0 and d.get("leaf_rel", 0.0) < LM_DP_REL, d
        else:
            print(f"{tag}: no expert axis (model 1), the MoE runs its dense "
                  f"path; the capacity-drop case runs on more cards")
    full = report["full"]
    f0 = full[0]
    print(f"[lm-mesh-dp] world {world} mesh (1, {world}) {LM_MESH_GQA} at "
          f"published width, {f0['layers']} of 36 layers "
          f"({f0['n_params'] / 1e9:.3f}B parameters, float32): "
          f"train_loop(dp=DPSGDConfig(), mesh=) {LM_DP_FULL_STEPS} steps of "
          f"{LM_DP_FULL_B} x {LM_DP_FULL_S} tokens in 2 microbatches, "
          f"losses {f0['losses']}; {f0['loop_s']:.2f} s, "
          f"{f0['step_s']:.2f} s a step; peak GiB per rank "
          f"{[round(r['peak_gib'], 3) for r in full]}; accountant "
          f"{f0['report']}")
    real = report["real_counts"]
    print(f"[lm-mesh-dp] reduced {LM_MESH_GQA} train step "
          f"({LM_DP_REAL_STEP[0]} x {LM_DP_REAL_STEP[1]}, 2 microbatches, "
          f"remat) on (1, {world}): rank 0's matrix-product FLOPs real "
          f"{real['flops']:.0f}, fake {fake['flops']:.0f}; collectives real "
          f"{real['collective_counts']}, fake {fake['collective_counts']}")
    if gates:
        assert all(r["finite"] for r in full), full
        assert f0["report"]["steps"] == LM_DP_FULL_STEPS, f0["report"]
        assert real["flops"] == fake["flops"] > 0, (real, fake)
        assert real["collective_counts"] == fake["collective_counts"], \
            (real, fake)


def phase_lm_mesh_dp(card, world=None):
    """[lm-mesh-dp] DP-SGD on a mesh on min(cards, 4) NCCL ranks.

    On each mesh of lm_mesh_meshes (on four cards (1, 4) and (2, 2); on one
    (1, 1)): (a) Qwen3-4B at published width, 4 of 36 layers, float32
    compute with TF32 off: one DP-SGD step (clip 1e-2, noise 1) against
    the one-card DP step from the same generator state; gates: the loss
    and every parameter and moment leaf within rel 1e-5 (of its max).  (b)
    Reduced DeepSeek-V2 at capacity factor 100 (nothing drops), auxiliary
    loss off: the clipped mean against the one card's, rel 1e-5.  (c) Where
    the model axis is larger than 1, reduced DeepSeek-V2 at capacity
    factor 1.0: dropped pairs > 0 and the clipped mean equal (rel 1e-5) to
    each example mesh clipping the whole batch alone (the one-card MoE
    computes every expert, so it has no drops to compare).  Then Qwen3-4B
    at published width, float32, full depth on four cards (8 of 36 layers
    on one), trained by train_loop(dp=DPSGDConfig(), mesh=(1, N)): step
    seconds, peak GiB per rank, the accountant's report (its steps the
    steps run).  Last, reduced Qwen3-4B's train step counted by OpStats on
    the real (1, N) mesh and on a fake one in a child process: the
    matrix-product FLOPs and the collectives of each kind equal.  No kernel
    of the port runs here."""
    t_phase = time.perf_counter()
    world = world or min(torch.cuda.device_count(), 4)
    free_device_memory()
    report = lm_mesh_spawn({"build": "build"}, world, "dp",
                           target=_lm_dp_rank, timeout=1800)
    fake = lm_dp_fake_counts(world)
    lm_dp_print(report, fake)
    secs = time.perf_counter() - t_phase
    print(f"[lm-mesh-dp] {secs:.1f} s in all")
    return secs


# ---------------------------------------------------------------------------
# [dryrun]: the port's dry run on fake tensors over a fake process group of
# 256 ranks (repro_torch.launch.dryrun), three single-pod cells in child
# processes on the host CPU (no card: CUDA_VISIBLE_DEVICES is empty and the
# fake tensors sit on the CPU device), started with the smoke and read at its
# end; their records scored by repro_torch.roofline.analyze with the H100 SXM
# datasheet row (counts, not measured times).
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
                ("recurrentgemma-2b", "prefill_32k"))
DRYRUN_DIR = os.path.join("build", "dryrun_torch")


def dryrun_start():
    """Start one child per DRYRUN_CELLS cell (each killed at exit if still
    running); returns (procs, t0).  The children run at the lowest
    priority on one thread each: they count fake tensors beside the
    phases, whose host work they would otherwise slow."""
    import atexit
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(
                   __file__)), "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        path = os.path.join(DRYRUN_DIR, f"{arch}__{shape}__single.json")
        if os.path.exists(path):
            os.remove(path)
        log = open(os.path.join(DRYRUN_DIR, f"{arch}__{shape}.log"), "w")
        procs.append((arch, shape, log, subprocess.Popen(
            ["nice", "-n", "19", sys.executable, "-m",
             "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "single", "--device", "cpu", "--out", DRYRUN_DIR],
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    atexit.register(lambda: [p.kill() for *_, p in procs if p.poll() is None])
    return procs, time.perf_counter()


def phase_dryrun(started, timeout=900):
    """[dryrun] wait for the cells, gate each at status ok, print their
    records' analyze rows and the seconds the wait added."""
    from repro_torch.roofline.analyze import analyze_cell, markdown_table
    procs, t_start = started
    t0 = time.perf_counter()
    cells = []
    for arch, shape, log, p in procs:
        t_cell = time.perf_counter()
        try:
            p.wait(timeout=max(timeout - (time.perf_counter() - t_start), 1))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        print(f"[dryrun] {arch} {shape}: {time.perf_counter() - t_cell:.1f} s "
              f"of waiting added by this cell")
        with open(os.path.join(DRYRUN_DIR,
                               f"{arch}__{shape}__single.json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {arch} {shape}: {rec.get('error')}")
        if "warmup_s" not in rec:
            raise AssertionError(f"[dryrun] {arch} {shape}: not a warm count")
        ma = rec["memory_analysis"]
        print(f"[dryrun] {arch} {shape} single (256 fake ranks, fake tensors on "
              f"the {rec['fake_device']} device): ok, counted warm in "
              f"{rec['trace_s']} s after a {rec['warmup_s']} s one-group "
              f"warm-up; per device: matrix-product FLOPs "
              f"{rec['op_stats']['flops']:.4e}, bytes "
              f"{rec['op_stats']['bytes']:.4e}, collectives "
              f"{rec['collective_counts']}, argument/output/temp GiB "
              f"{ma['argument_size_in_bytes'] / 2**30:.3f}/"
              f"{ma['output_size_in_bytes'] / 2**30:.3f}/"
              f"{ma['temp_size_in_bytes'] / 2**30:.3f}")
        cells.append(analyze_cell(rec))
    print("[dryrun] roofline of the counts, scored with the NVIDIA H100 SXM "
          "datasheet row (dense bf16 989.5 TFLOP/s, HBM 3.35 TB/s, NVLink "
          "900 GB/s; not times measured on a card):")
    print(markdown_table(cells))
    secs = time.perf_counter() - t0
    print(f"[dryrun] {secs:.1f} s added at the end (the cells ran beside the "
          f"other phases from {time.perf_counter() - t_start:.1f} s before)")
    return secs


# Phases that run in a child process on the same card beside the phases of
# the smoke's own process: both are host-bound (exact big-integer noise
# draws; float64 straddler assembly) and hold under a GiB of the card.
BACKGROUND_DIR = os.path.join("build", "background")


def background_start(name, arg=None):
    """Start phase ``name`` (``background_phase``) in a child process,
    ``python3 chip_smoke.py --phase name ARG``, ``arg`` passed as JSON; its
    output goes to a log under build/ and it is killed at exit if still
    running.  Returns what ``background_join`` takes."""
    import atexit
    os.makedirs(BACKGROUND_DIR, exist_ok=True)
    log_path = os.path.join(BACKGROUND_DIR, f"{name}.log")
    out_path = os.path.join(BACKGROUND_DIR, f"{name}.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase", name,
         json.dumps(arg), out_path], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return name, proc, log, log_path, out_path, time.perf_counter()


def background_join(started):
    """Wait for a ``background_start`` child, print its output and return
    the launch counts of its phase; a child that fails or is still running
    after 600 s more fails the smoke."""
    name, proc, log, log_path, out_path, t_start = started
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(log_path) as f:
        sys.stdout.write(f.read())
    print(f"[{name}] read {time.perf_counter() - t_start:.1f} s after its "
          f"child process started beside the other phases; waiting for it "
          f"added {time.perf_counter() - t0:.1f} s")
    if proc.returncode:
        raise AssertionError(f"[{name}] its child process exited "
                             f"{proc.returncode}")
    with open(out_path) as f:
        return json.load(f)


def background_phase(name, arg, out_path):
    """Run phase ``name`` in this process (``--phase``) with the smoke's
    settings and a tuning cache of its own; write its launch counts to
    ``out_path``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("REPRO_KERNEL_AUTOTUNE", None)
    os.environ.pop("REPRO_KERNEL_COMPUTE_DTYPES", None)
    fresh_tuning(name)
    card = card_line()
    if name == "secure-adult":
        from repro_torch.core import all_kway, select_sum_of_variances
        from repro_torch.data.tabular import adult_domain
        adult = adult_domain()
        counts = phase_secure_adult(card, adult, select_sum_of_variances(
            all_kway(adult, 3, include_lower=True), 1.0))
    elif name == "dnc-d200":
        counts = phase_dnc_d200(card, arg)
    else:
        raise ValueError(f"no background phase {name!r}")
    with open(out_path, "w") as f:
        json.dump(counts, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--phase"]:
        name, arg, out_path = sys.argv[2:5]
        background_phase(name, json.loads(arg), out_path)
        return 0
    from repro_torch.core import all_kway, select_sum_of_variances
    from repro_torch.data.tabular import (adult_domain, marginals_from_records,
                                          mixture_marginals, synth_domain,
                                          synthetic_records)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The main path runs the tuner in its default mode (model) over float32,
    # from an empty cache: no stale pick can hide it.
    os.environ.pop("REPRO_KERNEL_AUTOTUNE", None)
    os.environ.pop("REPRO_KERNEL_COMPUTE_DTYPES", None)
    fresh_tuning("main")
    t_start = time.perf_counter()
    dryrun = dryrun_start()      # [dryrun]'s cells run beside the phases
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # The planners' peak RSS, each in a child started while this process is
    # small: a forked child's peak starts at its parent's size.
    planned = {"d500": plan_in_child(DNC_D, 2, "dnc"),
               "d200": plan_in_child(DNC_AUTO_D, 3, "auto")}
    planned = {k: plan_in_child_read(p) for k, p in planned.items()}
    phase_build()
    rows = phase_kernels(card)
    phase_exact_edge(card)
    phase_small_reference()

    adult = adult_domain()
    plan = select_sum_of_variances(all_kway(adult, 3, include_lower=True), 1.0)
    adult_counts = release_phase(
        "adult", plan, lambda: marginals_from_records(
            adult, plan.cliques, synthetic_records(adult, ADULT_RECORDS, SEED)),
        6.0, by_kernel=True)
    if not (adult_counts["fused_launches"] > 0
            and adult_counts["axis_launches"] > 0):
        raise AssertionError(f"Adult release skipped a kernel: {adult_counts}")

    synth = synth_domain(10, SYNTH_D)
    t0 = time.perf_counter()
    splan = select_sum_of_variances(all_kway(synth, 3, include_lower=True), 1.0)
    print(f"[synth] select {time.perf_counter() - t0:.3f} s")
    synth_counts = release_phase(
        "synth", splan, lambda: mixture_marginals(
            synth, splan.cliques, 1e6, SEED), 7.0, by_kernel=True)
    if not synth_counts["fused_launches"] > 0:
        raise AssertionError(f"Synth release skipped the fused kernel: {synth_counts}")

    rplus_counts = phase_rplus_synth(), phase_rplus_adult(adult)
    adult_margs = marginals_from_records(
        adult, plan.cliques, synthetic_records(adult, ADULT_RECORDS, SEED))
    tune_counts, _picks, _modes = phase_autotune(card, [
        ("synth-10^%d" % SYNTH_D, engine_chains(splan)),
        ("adult", engine_chains(plan))], (plan, adult_margs))
    bf16_counts = phase_adult_bf16(card, adult, plan, adult_margs)
    # After the last phase that gates on a time: the two host-bound phases
    # run beside the rest from here, each in its own process.
    background = [background_start("secure-adult"),
                  background_start("dnc-d200", planned["d200"])]
    fresh_tuning("secure")
    opt = phase_select_device(card, plan.workload, splan.workload, splan)
    phase_select_convex(card, plan.workload, opt)
    synth2_counts, synth2_eng, synth2_margs = phase_secure_synth2(card, synth)
    release_counts = (
        phase_release_adult(card, plan, adult_margs),
        phase_release_adult_tree(card, adult, synthetic_records(
            adult, ADULT_RECORDS, SEED)),
        phase_release_synth(card, splan, mixture_marginals(
            synth, splan.cliques, 1e6, SEED)),
        phase_release_secure(card, synth2_eng, synth2_margs))
    synth2_records = synthetic_records(synth, SYNTH2_RECORDS, SEED)
    slice_counts = (
        phase_dnc_parity(card), phase_dnc_d500(card, planned["d500"]),
        phase_sharded_adult(card, adult, plan, synthetic_records(
            adult, ADULT_RECORDS, SEED), synth2_eng.plan, synth2_records),
        phase_obs(card, plan, adult_margs))
    phase_rplus_maxvar(card)
    serve_counts = phase_serve_adult(card, adult)
    phase_serve_cli(card)
    baseline_counts = tuple(phase_hdmm_synth(card) + phase_hdmm_prefix(card))
    # joined before the LM phases, which want the card's memory and the
    # host's
    secure_adult_counts, d200_counts = [background_join(b)
                                        for b in background]
    secure_counts = (secure_adult_counts, synth2_counts)
    phase_lm_serve(card)
    lm_train_counts = phase_lm_train(card)
    free_device_memory()
    phase_lm_mesh(card)
    phase_lm_mesh_train(card)
    phase_lm_mesh_dp(card)
    phase_dryrun(dryrun)
    counts = (adult_counts, synth_counts) + rplus_counts + (
        tune_counts, bf16_counts) + secure_counts + release_counts \
        + slice_counts + (d200_counts, serve_counts) + baseline_counts \
        + (lm_train_counts,)
    launches = {"fused_chain": sum(c["fused_launches"] - c["narrow_launches"]
                                   for c in counts),
                "fused_chain_bf16": sum(c["bf16_launches"] for c in counts),
                "fused_chain_fp16": sum(c["fp16_launches"] for c in counts),
                "kron_axis": sum(c["axis_launches"] for c in counts)}
    if not all(launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    fused_src = ("src/repro_torch/kernels/kron_matvec/csrc/fused_chain.cu",
                 "src/repro/kernels/kron_matvec/fused.py:262")
    sources = {"fused_chain": fused_src, "fused_chain_bf16": fused_src,
               "fused_chain_fp16": fused_src,
               "kron_axis": ("src/repro_torch/kernels/kron_matvec/csrc/kron_axis.cu",
                             "src/repro/kernels/kron_matvec/kron_matvec.py:55")}
    kernels = []
    for name in ("fused_chain", "fused_chain_bf16", "fused_chain_fp16",
                 "kron_axis"):
        mine = [r for r in rows if r["name"] == name]
        head = mine[0]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            case=head["case"], cases=mine))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
