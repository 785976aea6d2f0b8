#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) when it fails:
  1. device: the card's name, count, and `nvidia-smi` name/power limit;
  2. build: every CUDA source of the port (aggregation, RMSNorm, flash
     attention on the CUDA cores, its forward and its backward on the
     tensor cores, its hd-256 forward with the combine of its splits,
     its hd-256 backward with the merge of its head groups) built with
     nvcc for sm_90a, one nvcc per source, all started together, with
     ptxas's report (and a summary of the tensor-core, hd-256,
     short-sequence and aggregation kernels' registers and spills, which
     must be none);
  3. kernels against their plain PyTorch versions, forward and backward,
     at the main paths' shapes, the reference's test sweeps and one large
     shape each, with CUDA-event timings (kernel, plain version, one-call
     library yardstick) beside the least time the card could take for the
     same work; for the aggregation both designs (register, ring) at
     every shape, on permuted rows of a wider buffer, held to each other
     bit for bit, then timed against each other around the cut-off, and
     the ring's stages and tile bytes swept at the paper's size; for
     RMSNorm also the device and host time of a call and
     its kernels per call, two backward calls compared bit for bit, the
     other layouts' times at the zoo shape, and the host cost of the
     pieces of a wrapper call, and at the path's shape the kernel's and
     the float32 plain version's errors against float64 (`rmsnorm f64`);
     for attention the route (tensor cores or
     CUDA cores) of both directions on every row, checked against the
     launch counts, the tensor-core backward's errors with P and dS in one
     bf16 part and in two, and at the path's and the zoo shape the device
     and host time of a call and its kernels per call (the zoo forward
     one tensor-core kernel, its backward three, each timed), with the
     CUDA-core route's time on the zoo inputs beside them; every row that
     takes the short-sequence kernels (`short_fits`: the path's training
     and evaluation calls and a sweep at S = 8 and 32) has its device and
     host time, one kernel a call either way, and the older CUDA-core
     kernels' time on the same inputs (their device time too at the
     path's shapes); the model zoo's decode calls (`flash decode` rows:
     one query a head at Sk 1-576, and as the path makes them, the 4
     query heads of a kv head as 4 rows; forward only, SDPA beside them)
     and its RMSNorm shapes (qwen3-8b's prefill and decode norms,
     mamba2-370m's); the families' prefill and decode calls and norms
     (the bf16 calls at padded hd 256 on the hd-256 tensor-core forward,
     split over keys at decode with one combine launch, the CUDA-core
     forward's time on the same inputs beside them; at recurrentgemma-
     9b's full-window decode call the splits' partial results and the
     combine held apart, a `flash combine` row, and other split counts
     timed); the bf16 backward calls at padded hd 256 (recurrentgemma-
     9b's train call, gemma3-12b's at hd 240, a GQA x mask sweep) on the
     hd-256 tensor-core backward, two calls bit for bit, P and dS in one
     bf16 part and in two, and at the first two the CUDA-core backward's
     time on the same inputs and each head-group count's; the FL round's
     norms (`RMS_LAUNCH_SHAPES`); then one attention call
     of the path as the adapter makes it, traced: the two short kernels
     and no copy;
  4. the quickstart path: the FedBuff federation of examples/quickstart.py
     (MLP payload) through `Federation.from_experiment(exp)`'s engine on
     the card (the engine's fast loop, the default: each chunk of windows
     one CUDA graph replay), launch counts read around it (one
     aggregation launch per aggregation), then the card's host loop
     (`fast_loop=False`) held to it bit for bit (`strategies` line:
     counters, histogram, evaluation windows, columns, params; each run's
     wall, chunks, scans, graph captures and replays, the engine's device
     reads and the synchronizing calls torch saw), then the same
     experiment on the CPU as the check; then the fast loop's own phase
     (`fastloop` lines): (a) a graph replay against the eager scan on the
     card at buckets 1, 8 and 128, ground-only, sink and gossip, on the
     fault study's world under churn40, bit for bit, each bucket timed
     both ways; (b) a stop requested mid-chunk at windows 0 and 17
     against a run of stop + 1 windows;
  5. the transformer path: the same FedBuff world with the transformer
     payload (RMSNorm and attention in the kernels, forward and backward)
     over its first 96 of 288 windows (`TRANSFORMER_WINDOWS`) on the
     card, launch counts read around it, then on the CPU, and one
     batched client update of 20 satellites held leaf by leaf against the
     CPU's from the same parameters and batches, beside the spread of the
     CPU's and of the card's own update under a 1e-7 nudge; every
     attention call on the short-sequence kernels; and that client update
     traced (kernels, copy kernels and device time per SGD step, the
     step's wall and the device's busy share); then, in a fresh process
     (`scripts/trace_aggregation.py`), aggregations of both paths traced
     (`aggregation trace`: kernels, copy kernels, device and host
     microseconds from the last client update to the new params);
  6. the FedSpace path (`fedspace` lines): (a) the quickstart world under
     FedSpace with a histogram-only forest (no split on the status T),
     over its first 144 of 288 windows (`FEDSPACE_HIST_WINDOWS`), through `Federation.from_experiment(exp).run()` on the card, launch
     counts read around it (one aggregation launch per aggregation),
     the card's host loop held to its fast loop (every re-plan's schedule
     too), then on the CPU: counters and every re-plan's schedule equal;
     (b)
     the quickstart's FedSpace row as a user runs it: phase 1 on the card
     (its seconds, the regressor's in-sample R^2; the eq.-12 samples
     generated twice, bit for bit alike, and the forest refitted on them
     the federation's), the run on the card (wall, days to 35%, counters,
     launches) and on the CPU with the same regressor: counters and
     schedules equal; (c) one re-plan's `score_candidates` timed at the
     quickstart's shape and the paper's (R 5000, K 191), with its device
     events and time;
  7. the DenseNet path (`densenet` lines), Part A of
     examples/satellite_fl_train.py (48 satellites, 2 days, the DenseNet
     adapter's widths with the first block frozen): (a) under FedBuff
     (M 8) over its first quarter day (24 of 144 windows) on the card,
     launch counts read around it (one
     aggregation launch per aggregation), and on the CPU from the same
     initial model: counters equal, the frozen leaves bit for bit the
     initial model on both devices, the final models and accuracies as
     near as a one-rounding nudge of the initial model moves the card's
     own; (b) Part A as a user runs it, FedSpace with phase 1 on the card
     (its seconds by part, R^2), the run over its first 48 windows (wall,
     counters, launches), then on the CPU with the
     forest carried across: counters and every re-plan's
     schedule equal, or parted only on a forest split on the status T,
     both values printed (ROADMAP C13); (c) one client update at M 8 and
     M 20 held leaf by leaf against the CPU's and repeated bit for bit on
     the card, then traced (`densenet client step`);
  8. the scenarios (`scenarios` lines), link budgets and inter-satellite
     links through the repo's examples: (a) every policy of
     examples/scheduler_comparison.py (starlink40, 384 windows, its
     ISLConfig; the chaos-held async and isl_async over the first 24,
     fedbuff and periodic over the first 96) on
     the card and on the CPU, FedSpace with phase 1 on the
     card (its seconds) and the forest carried to the CPU, sync also on
     the card's host loop, held to the fast loop; (b) the
     binding cell of examples/isl_comparison.py (starlink40 over sparse1
     under a finite budget; its blocked share): fedbuff, intra_plane,
     isl_async and FedSpace's link-gated search, card against CPU, with
     the final `progress` and `relay` columns; counters, histograms and
     columns equal, FedSpace's re-plans under ROADMAP C13, one
     aggregation launch per aggregation in every run; (c) a re-plan's ms
     with and without the gate;
  9. the fault study (`faults` lines), examples/fault_study.py's world
     (starlink40 over dense12, 192 windows, its budget and ISLs) and its
     five fault worlds: (a) the 15 sweepable cells (sync, fedbuff,
     intra_plane) through `sweep_engines` (the call `run_sweep` makes) on
     the card and on the CPU, every outcome equal, the card's window loops
     under `torch.cuda.set_sync_debug_mode("error")`, groups and walls
     printed, and three cells run one by one through the card's `.run()`,
     equal to the sweep; (b) FedSpace under each fault world and under
     churn40 as an oracle, over the first 48 windows
     (`FAULT_FEDSPACE_WINDOWS`), phase 1 once on the card and the forest
     carried to the CPU, card against CPU as in the scenarios; (c) the traces'
     numbers (alive satellites at the end, contacts and grant units
     removed);
  10. the compression phase (`compression` lines): (a) the top-k 0.25
     and dense int8 uplink roundtrips card against CPU on seeded update
     rows of the transformer payload's leaves at M 20 and Part A's
     DenseNet's at M 8 (kept index sets equal, values within one quantum,
     frozen leaves 0), then both timed on one flat leaf of the paper's
     size (M 20, N 26,608,958) beside one read and one write of it; (b)
     part (b) of the `payloads` section of benchmarks/hotpaths.py, 12
     runs card and CPU over the first 48 of its 192 windows
     (`STUDY_WINDOWS`): every counter equal, need_up lower with
     compression, need_dn unchanged, the aggregated-gradient counts
     shifted, one aggregation launch per aggregation, RMSNorm and
     attention in the transformer cells;
  11. the replan phase (`replan` lines): (a) the `replan` section of
     benchmarks/hotpaths.py at its serving shape (K 1000, R 20000, I0 24,
     8 windows) on the card, every answer a full rescan's schedule, at
     least one delta; warm delta, full-rescan and `maintain()` ms, and
     each answer's device events and ms (`torch.profiler`); (b) K 40, R
     2000, I0 12 card against CPU: pools, stats, modes, schedules equal;
     (c) the quickstart's FedSpace row routed through a `ReplanService`
     on the card, equal to the unrouted run, its `replan_stats`;
  12. the cli phase (`cli` line): `python -m repro_torch.launch.fl_train`
     (the verify recipe's fast smoke) as a subprocess on the card: exit
     0, the summary, one JSONL line per evaluation, one aggregation
     launch per aggregation, the integers of the CPU's in-process run;
  13. the zoo phase (`zoo` lines), the model zoo's serving path
     (`repro_torch.launch.steps`, `models/transformer.py`): (a) the three
     reduced archs of examples/serve_decode.py and qwen3-8b's, its serve
     loop on the card and on the CPU in float32 from the same parameters:
     greedy tokens equal, every step's logits and the final caches within
     `ZOO_F32_TOL`; (b) qwen3-8b at full width in bfloat16 drawn on the
     card: the prefill step at B 1 x S 2048 (its ms, 36 tensor-core
     attention launches) against the same forward with the plain versions
     swapped in by this script (`PlainVersions`), within
     `QWEN_BF16_REL_TOL`; the serve loop at B 8 (a 512-token prompt
     stepped, 64 tokens generated, a 2,048-slot cache): ms a decode step,
     tokens/s, launches a step, peak memory, four steps traced (kernels,
     copy kernels, device µs, busy share), and row 0's logits after the
     stepped prompt against a prefill of it; (c) mamba2-370m at full
     width in float32, 16 of its 48 layers: the chunked prefill of 2,048
     tokens against the same prompt stepped through `ssm_decode`, within
     `MAMBA_REL_TOL`;
  14. the families phase (`families` lines), the zoo's three last
     families (recurrentgemma's RG-LRU with local attention, whisper's
     encoder and cross-attention, phi-3-vision's image frontend): (a)
     their reduced configs and recurrentgemma's hybrid (two recurrent
     layers and a local one), the prefill step and the serve loop on the
     card and on the CPU in float32 from the same parameters: greedy
     tokens equal, the prefill's and every step's logits and the final
     caches within `ZOO_F32_TOL`, attention launched iff a layer attends;
     (b) each at full width in bf16 drawn on the card: the prefill step
     (recurrentgemma B 1 x S 4096; phi-3-vision 576 image embeddings and
     1,472 tokens; whisper B 8, 1,500 frames and 448 tokens) timed, its
     launches asserted and its next-token logits against the plain
     versions' (`PlainVersions`, within `FAMILIES`' tolerances); the serve
     loop at B 8 (whisper's state from its encoder's frames) timed, its
     launches a step asserted, peak memory, four steps traced, the greedy
     tokens and the next-token logits against the same inputs stepped
     with the plain versions, row 0 after the stepped prompt against a
     prefill of it; recurrentgemma's step at a full window (index 4,095,
     random caches) timed and traced; every RMSNorm call at a shape
     `check_rmsnorm` held. The phase's kernel shapes are rows of phase
     3 (`FLASH_FAMILIES`, `FLASH_DECODE_FAMILIES`, `RMS_FAMILY_SHAPES`);
  15. the train phase (`train` lines), the zoo's train step
     (`repro_torch.launch.steps.make_train_step`: the loss and its gradient
     with remat, microbatches, clipping, AdamW): (a) the 8 served archs'
     and the families' reduced configs in float32, two steps of two
     microbatches on the card and on the CPU, each step from the same state
     and `synthetic_lm_batch` batch: loss, grad_norm, params and AdamW's m
     and v within the `TRAIN_*` tolerances; (b) qwen3-8b at full width in
     bf16, cut to `QWEN_TRAIN_LAYERS` of its 36 layers for memory, B 2 x S
     2048 in `default_num_micro` microbatches: one step's loss and
     gradients against the plain versions' (`PlainVersions`, within
     `QWEN_TRAIN_*_TOL`), two steps from copies of one state bit for bit,
     the launches a step asserted (the tensor-core attention backward's
     first path), its RMSNorm calls all at shapes `check_rmsnorm` held, ms
     a step, tokens/s, `mfu` (model FLOPs, 6·N·tokens plus causal
     attention, over the bf16 peak), peak memory, one step run as its two
     halves with CUDA events between them (the optimizer's share), the next
     traced whole (kernels, copies, device µs, busy share, the attention
     backward's share, the 10 slowest kernels; its launches must be the
     halves'); (c) Part B of examples/satellite_fl_train.py as the
     reference runs it (`launch.train.train`, mamba2-370m's full config, 24
     steps at B 4 x S 64) on the host mesh (`launch.mesh.make_host_mesh`:
     the data-parallel ZeRO-1 step at a world of one, on the NCCL group
     started before this phase, so the group's start is outside its wall):
     its loss must fall, its RMSNorm calls at held shapes; (d) recurrentgemma-9b as (b), cut to `RG_TRAIN_LAYERS` of
     its 38 layers (two of them local attention) at B 2 x S 4096, so that
     each microbatch's attention, forward and backward, is `FLASH_RG` on
     the hd-256 tensor-core kernels (the hd-256 backward's path);
  16. the launch phase (`launch` lines), the launch tools
     (`repro_torch.launch.steps`' agg steps and FL round, `launch.
     dryrun`): (a) the agg step and the bf16-product agg step for every
     served arch's reduced config (the train phase's list) and the FL
     round for reduced qwen3-8b and mamba2-370m (M 3, 2 local SGD steps,
     B 2 x S 32), float32, card against CPU from the same params, one
     aggregation launch a step or round; (b) the agg step at full width
     in bf16, params and updates random from a seed as views of one
     buffer each (`flat_tree`): whisper-base's agg_m96 (M 96) and
     qwen3-8b at M 2 (N 8,190,735,360, past 2^31), one launch a step,
     the output against the plain version over column windows (the first
     element, around 2^30, 2^31 and 2^32, the last), the peak memory
     within `PEAK_SLACK` of params + updates + output, the kernel, its
     plain version and `addmv` timed (`launch (b)`); (c) the FL round of
     mamba2-370m's flround_m16 with no cut (M 16, 4 local SGD steps, B 8
     x S 512, bf16): its wall, the clients' and the aggregation's
     shares, the launches a round counted from the code, the peak memory
     (no copy of the float32 update stack), its RMSNorm calls at held
     shapes (`RMS_LAUNCH_SHAPES`) and the aggregation's output against
     the plain version on the same rows; (d) the record of `python -m
     repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k`, run in
     a fresh process with no card visible beside the build and waited for
     before the kernel checks, so that it loads no timed phase: it must
     say ok; its terms printed;
  17. the satellite-axis mesh on the world-1 NCCL group started before
     the train phase (`mesh` lines), last because ending the group leaves
     a thread behind: (a) the mesh gate's
     K 1,000 run, fast and host loop, with the mesh and with
     `mesh=None`, bit for bit; (b) `score_candidates(mesh=)` at K 191 /
     R 5,000; (c) `ReplanService(mesh=)` at K 1,000 / R 20,000, each
     against the unsharded result and timed;
  18. the zoo's mesh on the same group, before it ends (`zoo mesh`
     lines, `run_zoo_mesh_path`): (a) `make_production_mesh()` refused
     on one card, `make_host_mesh()` (1, 1); (b) qwen3-8b at 8 layers,
     two train steps on the host mesh (data parallel, ZeRO-1) = two with
     `mesh=None`, bit for bit; (c) qwen3-moe-30b-a3b at 4 of 48 layers,
     the expert-parallel loss and gradients against the grouped path's
     and the plain versions', each step timed; (d) `make_agg_step_opt`
     at whisper-base's agg_m96 on the host mesh = `mesh=None`, timed;
  19. tensor parallelism on the card (`zoo tp` lines,
     `run_zoo_tp_path`), after the NCCL group has ended: two ranks
     spawned over a gloo group, both on the one card, the mesh (1, 2)
     over (data, model); (a) qwen3-8b at full width cut to
     `ZOO_TP_LAYERS` layers: prefill at B 1 x S 2048, 8 greedy serve
     steps at B 8 and one train step at B 2 x S 2048 (its loss and
     gradients first), each against `mesh=None` on the card run first and
     freed (loss, grad norm, named gradient leaves, logits, tokens); (b)
     qwen3-moe-30b-a3b cut to `ZOO_TP_MOE_LAYERS` layers in float32, 64
     experts a rank: the loss and gradients against `mesh=None`, with
     the tokens whose expert set differs; every rank's
     attention calls at its per-rank heads, its RMSNorm calls at held
     shapes, ms and peak memory (gloo carries the collectives through
     host memory: these are not NVLink's times);
  20. one JSON line listing every ported kernel.
The last line is `{"ok": true,
"device": {...}}`. Without a CUDA device, or away from the repository's
sources, it exits nonzero and prints no result. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The bounds' rates and formulas (H100 SXM data sheet: HBM, float32 on the
# CUDA cores, bf16 on the tensor cores) are the package's, which the dry
# run's op counter reads too: `repro_torch/kernels/cost.py`.
from repro_torch.kernels import cost  # noqa: E402

# The flat models one aggregation launch covers (`FlatLayout`: leaves on
# 16 bytes): the quickstart MLP, F=32 -> 48 -> 62 (4,622 parameters, no
# gaps), and the transformer payload (20,766 parameters in 20,768).
QUICKSTART_N = 4_622
TRANSFORMER_N = 20_768
DENSENET_N = 12_512                        # Part A's DenseNet, 28 leaves
FAULT_N = 6_144     # the fault study's and the ISL cell's MLP, F=32 -> 64
                    # -> 62 (6,142 parameters)
FAULT_M = 10                               # fedbuff/intra_plane M there
DENSENET_M = 8                             # fedbuff M of the DenseNet path
PAPER_N = 26_608_958                       # DenseNet-161, 62-class head
PAPER_M = 191                              # flock191 satellites
MAIN_PATH_M = 20                           # fedbuff M of the quickstart
AGG_TOL = 2e-5      # float32 outputs: the same products summed in another
                    # order (the float32 tolerance of tests/test_kernels.py)
# The register design against the ring around the cut-off
# (`kernel.py::RING_MIN_N`), and the ring's stages and tile bytes a row at
# the paper's size.
AGG_CUTOFF_N = (65_536, 262_144, 1_048_576, 4_194_304, 8_388_608,
                16_777_216, PAPER_N)
AGG_STAGES = (2, 3, 4, 6, 8, 12)
AGG_TILES = (8192, 16384, 32768)


def _time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _agg_inputs(torch, g, m, n, udt):
    """M update rows, permuted, in a buffer of M + 3 rows 64 elements
    apart (as the engine's), float32 params, normalised weights, and the
    weights scattered onto the buffer's rows (for `addmv`)."""
    ld = -(-n // 64) * 64
    buf = torch.randn(m + 3, ld, generator=g, device="cuda").to(udt)
    rows = torch.randperm(m + 3, generator=g, device="cuda")[:m].int()
    p = torch.randn(n, generator=g, device="cuda")
    w = torch.rand(m, generator=g, device="cuda")
    w /= w.sum()
    w_rows = torch.zeros(m + 3, device="cuda").index_put_((rows.long(),), w)
    return buf[:, :n], rows, p, w, w_rows


def _both_designs(torch, K, p, upd, w, rows, iters, **ring):
    """The register design's and the ring's outputs (asserted bit-equal)
    and their times."""
    outs, ms = {}, {}
    for design in K.DESIGNS:
        kw = dict(ring) if design == "ring" else {}
        outs[design] = K.weighted_aggregate(p, upd, w, rows, design=design,
                                            **kw)
        ms[design] = _time_ms(lambda: K.weighted_aggregate(
            p, upd, w, rows, design=design, **kw), iters)
    torch.cuda.synchronize()
    if not torch.equal(outs["register"], outs["ring"]):
        raise AssertionError(f"the register design and the ring differ "
                             f"({ring})")
    return outs["register"], ms


def check_aggregation(torch):
    """Phase 3: the agg kernel's two designs against each other (to the
    bit) and against the plain version, on permuted rows of a wider
    buffer, at the main paths' flat models and the paper's size; then
    the two designs around the cut-off, and the ring's stages and tiles
    at the paper's size."""
    from repro_torch.kernels.agg import kernel as K
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, n) for n in (QUICKSTART_N, TRANSFORMER_N, DENSENET_N)
              for m in (1, MAIN_PATH_M, 40)] + [(DENSENET_M, DENSENET_N),
                                                (FAULT_M, FAULT_N),
                                                (MAIN_PATH_M, FAULT_N),
                                                (MESH_GATE["M"], 2),
                                                (PAPER_M, PAPER_N)]
    rows_out = []
    for m, n in shapes:
        for udt in (torch.float32, torch.bfloat16):
            upd, rows, p, w, w_rows = _agg_inputs(torch, g, m, n, udt)
            iters = 10 if n == PAPER_N else 200
            out, ms = _both_designs(torch, K, p, upd, w, rows, iters)
            ref = weighted_aggregate_ref(p, upd, w, rows)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = bool(torch.allclose(out, ref, rtol=AGG_TOL, atol=AGG_TOL))
            p_ms = _time_ms(lambda: weighted_aggregate_ref(p, upd, w, rows),
                            iters)
            # one PyTorch call computing the same function (a cuBLAS gemv
            # over the whole buffer, the weights on the rows they name);
            # none takes bfloat16 updates into float32 params
            lib_ms = _time_ms(lambda: torch.addmv(p, upd.t(), w_rows),
                              iters) if udt == torch.float32 else None
            bound, by = cost.bound(*cost.agg(m, n, upd.element_size()),
                                   cost.FP32_FLOP_PER_S)
            design = K.design_for(n, upd.stride(0) * upd.element_size())
            row = {"m": m, "n": n, "updates": str(udt).split(".")[-1],
                   "max_abs_err": err, "tol": AGG_TOL, "design": design,
                   "kernel_ms": ms[design], "register_ms": ms["register"],
                   "ring_ms": ms["ring"], "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                   "bound_share": bound / ms[design],
                   "register_share": bound / ms["register"],
                   "ring_share": bound / ms["ring"]}
            print("agg", json.dumps(row), flush=True)
            if not ok:
                raise AssertionError(f"agg kernel disagrees with its plain "
                                     f"version at {row}")
            rows_out.append(row)
            del upd, rows, p, w, w_rows, out, ref
            torch.cuda.empty_cache()
    for m in (MAIN_PATH_M, PAPER_M):
        for n in AGG_CUTOFF_N:
            upd, rows, p, w, _ = _agg_inputs(torch, g, m, n, torch.float32)
            _, ms = _both_designs(torch, K, p, upd, w, rows, 50)
            print("agg cutoff", json.dumps({
                "m": m, "n": n, "updates": "float32",
                "register_ms": ms["register"], "ring_ms": ms["ring"],
                "bound_ms": cost.bound(*cost.agg(m, n, 4),
                                       cost.FP32_FLOP_PER_S)[0]}),
                  flush=True)
            del upd, rows, p, w
    for udt in (torch.float32, torch.bfloat16):
        # the first version's layout: rows N apart, N % 4 = 2, so the
        # register design takes its one-column-a-thread instantiation
        upd = torch.randn(PAPER_M, PAPER_N, generator=g, device="cuda").to(
            udt)
        p = torch.randn(PAPER_N, generator=g, device="cuda")
        w = torch.full((PAPER_M,), 1 / PAPER_M, device="cuda")
        print("agg unpadded", json.dumps({
            "updates": str(udt).split(".")[-1], "row_stride": PAPER_N,
            "register_ms": _time_ms(lambda: K.weighted_aggregate(
                p, upd, w, design="register"), 10)}), flush=True)
        del upd, p, w
        torch.cuda.empty_cache()
        upd, rows, p, w, _ = _agg_inputs(torch, g, PAPER_M, PAPER_N, udt)
        bound = cost.bound(*cost.agg(PAPER_M, PAPER_N, upd.element_size()),
                           cost.FP32_FLOP_PER_S)[0]
        for tile in AGG_TILES:
            for stages in AGG_STAGES:
                if not K.ring_fits(stages, tile):
                    continue
                _, ms = _both_designs(torch, K, p, upd, w, rows, 5,
                                      stages=stages, tile_bytes=tile)
                print("agg sweep", json.dumps({
                    "updates": str(udt).split(".")[-1], "stages": stages,
                    "tile_bytes": tile, "ring_ms": ms["ring"],
                    "bound_share": bound / ms["ring"]}), flush=True)
        del upd, rows, p, w
        torch.cuda.empty_cache()
    return rows_out


def _tol(dtype, grad: bool = False):
    """(rtol, atol) of a kernel against its plain version on the card.
    float32: the same float32 arithmetic summed in another order (the
    float32 tolerance of tests/test_kernels.py; 1e-4 for gradients, which
    sum up to tens of thousands of products). bfloat16: both round the
    same float32 result once, and a result near a rounding boundary may
    round the other way, by one unit in the last place: at most 2**-7 of
    the value, under rtol 1e-2; atol 1e-2 covers values near 0. The
    largest bfloat16 errors this script has read on an H100 are 0.0039 and
    0.016 (attention forward and backward, qwen3-8b's heads at S=2048),
    0.0156 (RMSNorm at (16384, 4096): one unit at outputs of 2 to 4) and
    0.5 (its dscale: sums over 16384 rows, a few hundred, where one unit
    is 1 or 2)."""
    import torch
    if dtype == torch.bfloat16:
        return 1e-2, 1e-2
    return (1e-4, 1e-4) if grad else (2e-5, 2e-5)


def _compare(name, outs, refs, dtype, grad=False):
    """Largest |kernel - plain| over outputs; raises beyond tolerance.
    An entry that is -inf in both (the log-sum-exp of a row that sees no
    key) counts as equal; -inf in one alone fails."""
    import torch
    rtol, atol = _tol(dtype, grad)
    err = 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        same_inf = torch.isinf(r) & (o == r)
        err = max(err, torch.where(same_inf, 0.0, o - r).abs().max().item())
        if not torch.allclose(o, r, rtol=rtol, atol=atol):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max |diff| {err}, rtol {rtol},"
                                 f" atol {atol})")
    return err, f"rtol {rtol}, atol {atol}"


def _grad_ms(fn, inputs, cotangent, iters):
    """Time of the backward alone of one call of `fn` (graph built once)."""
    import torch
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return _time_ms(lambda: torch.autograd.grad(out, leaves, cotangent,
                                                retain_graph=True), iters)


# RMSNorm shapes (G scale rows, R rows each, D), dtype, and the offset in
# elements at which x starts in its buffer: the transformer path's
# training call (20 satellites x 32 samples x 8 tokens, d_model 32) and
# evaluation call (1000 samples x 8 tokens, one scale), the sweep of
# tests/test_kernels.py, one zoo width, and the edges of the kernels'
# paths: a width of 72 bytes (the 1-wide path), an x one element into its
# buffer (unaligned: the 1-wide path), several groups whose rows are no
# multiple of a tile, and rows wider than the registers hold (the
# row-looping kernels): D = 20,000 float32 (one tile), 32,768 bfloat16 and
# 4,100 float32 one element into its buffer (several tiles a group).
RMS_PATH = (20, 256, 32)
RMS_ZOO = (1, 16384, 4096)
RMS_SHAPES = [(RMS_PATH, "float32", 0), ((1, 8000, 32), "float32", 0)] + [
    (shape, dt, 0) for shape in ((1, 4, 128), (1, 15, 256), (1, 37, 512))
    for dt in ("float32", "bfloat16")] + [
    (RMS_ZOO, "bfloat16", 0), ((4, 300, 36), "bfloat16", 0),
    ((2, 100, 256), "float32", 1), ((8, 1000, 1024), "float32", 0),
    ((1, 16, 20_000), "float32", 0), ((2, 40, 32_768), "bfloat16", 0),
    ((3, 300, 4_100), "float32", 1)]
# The zoo's shapes: qwen3-8b's prefill (B 1 x S 2048) block norm
# and qk-norm (2048 tokens x 32 heads of 128), its decode step at B 8
# (block norm, qk-norm of 8 x 32 heads), mamba2-370m's out_norm over its
# inner width 2048 at S 2048 and its block norm at one token; the train
# step's: qwen3-8b's k-norm (2048 tokens x 8 kv heads of 128) and Part
# B's mamba2-370m at B 4 x S 64 in bf16 (block and final norms over
# 1024, out_norm over 2048). `RmsCalls` holds the train path to them.
RMS_ZOO_DECODE = (1, 8, 4096)
RMS_ZOO_SHAPES = [((1, 2048, 4096), "bfloat16", 0),
                  ((1, 65536, 128), "bfloat16", 0),
                  (RMS_ZOO_DECODE, "bfloat16", 0),
                  ((1, 256, 128), "bfloat16", 0),
                  ((1, 2048, 2048), "float32", 0),
                  ((1, 1, 1024), "float32", 0),
                  ((1, 16384, 128), "bfloat16", 0),
                  ((1, 256, 1024), "bfloat16", 0),
                  ((1, 256, 2048), "bfloat16", 0)]
RMS_SHAPES += RMS_ZOO_SHAPES
# The families phase's shapes, bf16, a shared scale over B x S rows:
# recurrentgemma-9b's prefill (B 1 x S 4096; its decode step's (1, 8,
# 4096) is qwen3-8b's), phi-3-vision's prefill (576 image and 1,472 text
# positions) and decode step at B 8, whisper-base's encoder (8 x 1,500
# frames), decoder prefill (8 x 448 tokens) and decode step at B 8.
# `RmsCalls` holds the phase's (b) to them.
RMS_FAMILY_SHAPES = [((1, 4096, 4096), "bfloat16", 0),
                     ((1, 2048, 3072), "bfloat16", 0),
                     ((1, 8, 3072), "bfloat16", 0),
                     ((1, 12000, 512), "bfloat16", 0),
                     ((1, 3584, 512), "bfloat16", 0),
                     ((1, 8, 512), "bfloat16", 0)]
RMS_SHAPES += RMS_FAMILY_SHAPES
# The launch phase's FL round: mamba2-370m at B 8 x S 512 in bf16, its
# block and final norms over 1024 and its out_norm over 2048. `RmsCalls`
# holds its (c) to them.
RMS_LAUNCH_SHAPES = [((1, 4096, 1024), "bfloat16", 0),
                     ((1, 4096, 2048), "bfloat16", 0)]
RMS_SHAPES += RMS_LAUNCH_SHAPES
# The zoo tp phase's per-rank shapes at a model axis of 2: qwen3-8b's q-
# and k-norms over its 16 query and 4 kv heads of 128 a rank at S 2048
# (prefill, a train microbatch) and at a decode step of B 8, bf16; and
# qwen3-moe-30b-a3b's in float32, its q-norm over 16 heads and k-norm
# over its 2 kv heads a rank (its block norm over d_model 2048 is
# mamba2-370m's out_norm shape). `RmsCalls` holds the phase to them.
RMS_TP_SHAPES = [((1, 32768, 128), "bfloat16", 0),
                 ((1, 8192, 128), "bfloat16", 0),
                 ((1, 128, 128), "bfloat16", 0),
                 ((1, 32, 128), "bfloat16", 0),
                 ((1, 32768, 128), "float32", 0),
                 ((1, 4096, 128), "float32", 0)]
RMS_SHAPES += RMS_TP_SHAPES
RMS_EPS = 1e-6


def _device_events(prof):
    """(name, count, device us) of each kernel or copy the profiler saw on
    the device (host ops also report the device time of what they
    launched, and are left out)."""
    out = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        t = getattr(e, "self_cuda_time_total", 0) if t is None else t
        if t > 0:
            out.append((e.key, e.count, t))
    return out


def _host_and_device(fn, iters):
    """Per call of `fn`: host microseconds (host clock over `iters` calls,
    no synchronising inside); device microseconds per kernel and kernels
    launched per call, from `torch.profiler`'s `key_averages()` over
    `iters` calls; the names of the kernels seen; and the kernel events
    the profiler recorded. On the H100 machines the profiler drops some
    kernel events (1 to 39 of 200 in a few runs), never adds any, and in
    one run recorded none in a window of 50 calls: the kernels per call are
    the events over the calls rounded up, the device time per call the
    device time per event times that, and a window with no device event is
    traced again, three times at most. Also each kernel's device
    microseconds per event, by name."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = _device_events(prof)
        if seen:
            break
    if not seen:
        raise AssertionError("torch.profiler shows no device time")
    dev_us = sum(t for _, _, t in seen)
    events = sum(c for _, c, _ in seen)
    names = [n for n, _, _ in seen]
    by_name = {n: t / c for n, c, t in seen}
    per_call = -(-events // iters)
    return (host_us, dev_us / events * per_call, per_call, names, events,
            by_name)


def _rms_layouts(K, x, scale, rstd, dy, refs):
    """At the zoo shape: the kernels' time under each layout the wrapper
    could choose (threads per row x loads per thread), each checked
    against the plain version; the default is the first of each."""
    G, R, D = x.shape
    vec = K.vector_width(D, x.element_size(), x.data_ptr())
    out = {}
    for direction, default, choices, run in (
            ("fwd", K.FWD_LOADS, (2, 4, 8, 16),
             lambda m: K._fwd(x, scale, RMS_EPS, G, R, D, m)),
            ("bwd", K.BWD_LOADS, (2, 4, 8),
             lambda m: K._bwd(x, scale, rstd, dy, G, R, D, m))):
        assert choices[0] == default
        times = {}
        for m in choices:
            t, nl = K.layout(D // vec, vec > 1, m)
            got = run(m)
            _compare(f"rmsnorm {direction} layout {m}", got[:1], refs[
                direction], x.dtype, grad=direction == "bwd")
            times[f"{1 << t} threads x {nl} loads"] = _time_ms(
                lambda: run(m), 20)
        out[direction] = times
    return out


def _rms_host_pieces(K, torch):
    """Host microseconds of the pieces of one wrapper call at the path's
    training shape (5,000 calls of each after 100 of warm-up, no
    synchronising): the checks, the allocations (two, as the wrapper makes
    them, against one shared through views), the stream lookup (the raw
    pointer the wrapper reads, against `current_stream().cuda_stream`),
    the ctypes call alone (zero rows: no launch), and whole calls."""
    G, R, D = RMS_PATH
    x = torch.randn(G, R, D, device="cuda")
    scale = torch.randn(G, D, device="cuda")
    y, rstd = K.rmsnorm(x, scale, RMS_EPS)
    fwd, bwd = K._library()
    n, rows, dev = x.numel(), G * R, x.device

    def one_allocation():
        buf = torch.empty(n + rows, device=dev)
        a, b = buf.split([n, rows])
        return a.view(x.shape), b

    pieces = {
        "checks": lambda: K._check(x, scale),
        "two allocations": lambda: (torch.empty_like(x), torch.empty(
            rows, device=dev)),
        "one allocation, split and view": one_allocation,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "ctypes call, no launch (fwd)": lambda: fwd(
            0, 0, 0, 0, 0, 0, 0, 0.0, 0, 4, 3, 1, 0),
        "ctypes call, no launch (bwd)": lambda: bwd(
            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 3, 1, 0),
        "whole call (fwd)": lambda: K.rmsnorm(x, scale, RMS_EPS),
        "whole call (bwd)": lambda: K.rmsnorm_bwd(x, scale, rstd, x),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            fn()
        out[name] = (time.perf_counter() - t0) / 5000 * 1e6
        torch.cuda.synchronize()
    print("rmsnorm host_us", json.dumps(out), flush=True)
    return out


def _rms_f64_errors(x, scale, dy, kernel, plain):
    """The kernel's and the float32 plain version's errors against the
    function computed in float64 from the same inputs, for y, rstd, dx and
    dscale: `max_rel` is max |err| / max |f64 value|; `bias` is mean(err) /
    mean(|err|), near 0 when the errors are rounding noise of either sign,
    near 1 in size when an order of sums pushes them one way."""
    xd, sd, dyd = x.double(), scale.double()[:, None, :], dy.double()
    rstd = ((xd * xd).mean(-1, keepdim=True) + RMS_EPS).rsqrt()
    xh = xd * rstd
    gy = dyd * sd
    exact = (xh * sd, rstd.reshape(-1),
             rstd * (gy - xh * (gy * xh).mean(-1, keepdim=True)),
             (dyd * xh).sum(-2))
    out = {"shape": list(x.shape), "dtype": str(x.dtype)}
    for name, k, p, e in zip(("y", "rstd", "dx", "dscale"), kernel, plain,
                             exact):
        top = float(e.abs().max())
        row = {}
        for who, got in (("kernel", k), ("plain_f32", p)):
            err = got.double().reshape(e.shape) - e
            row[who + "_max_rel"] = float(err.abs().max()) / top
            mean_abs = float(err.abs().mean())
            row[who + "_bias"] = float(err.mean()) / mean_abs \
                if mean_abs else 0.0
        out[name] = row
    return out


def check_rmsnorm(torch):
    """Phase 3: RMSNorm forward and backward against the plain version,
    with the host and device time of a call and its kernel count."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref,
                                                 rmsnorm_fwd_ref)
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for (G, R, D), dts, off in RMS_SHAPES:
        dt = getattr(torch, dts)
        x = torch.randn(G * R * D + off, generator=g, device="cuda").to(dt)[
            off:].view(G, R, D)
        scale = (1 + 0.5 * torch.randn(G, D, generator=g, device="cuda")
                 ).to(dt)
        dy = torch.randn(G, R, D, generator=g, device="cuda").to(dt)
        y, rstd = K.rmsnorm(x, scale, RMS_EPS)
        y_ref, rstd_ref = rmsnorm_fwd_ref(x, scale, RMS_EPS)
        dx, ds = K.rmsnorm_bwd(x, scale, rstd, dy)
        dx2, ds2 = K.rmsnorm_bwd(x, scale, rstd, dy)
        # the plain backward starts from the plain forward's rstd
        dx_ref, ds_ref = rmsnorm_bwd_ref(x, scale, rstd_ref, dy)
        torch.cuda.synchronize()
        tag = f"rmsnorm G={G} R={R} D={D} {dts} offset={off}"
        fwd_err, fwd_tol = _compare(tag, (y,), (y_ref,), dt)
        rstd_err, _ = _compare(tag + " rstd", (rstd,), (rstd_ref,),
                               torch.float32)
        fwd_err = max(fwd_err, rstd_err)
        bwd_err, bwd_tol = _compare(tag + " bwd", (dx, ds), (dx_ref, ds_ref),
                                    dt, grad=True)
        if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
            raise AssertionError(f"{tag}: two backward calls differ")
        if (G, R, D) == RMS_PATH and dts == "float32":
            print("rmsnorm f64", json.dumps(_rms_f64_errors(
                x, scale, dy, (y, rstd, dx, ds),
                (y_ref, rstd_ref, dx_ref, ds_ref))), flush=True)
        big = x.numel() >= 1 << 24
        iters = 20 if big else 200
        n, b = x.numel(), x.element_size()
        sb = scale.numel() * scale.element_size()
        fwd_bound = cost.bound(*cost.rmsnorm_fwd(n, b, sb, G * R),
                               cost.FP32_FLOP_PER_S)
        bwd_bound = cost.bound(*cost.rmsnorm_bwd(n, b, sb, G * R),
                               cost.FP32_FLOP_PER_S)
        vec = K.vector_width(D, b, x.data_ptr(), scale.data_ptr())
        shared = G == 1    # one PyTorch call takes one (D,) scale only
        for direction, err, tol, bound, kern, plain, lib, loads in (
                ("fwd", fwd_err, fwd_tol, fwd_bound,
                 lambda: K.rmsnorm(x, scale, RMS_EPS),
                 lambda: rmsnorm_fwd_ref(x, scale, RMS_EPS),
                 (lambda: F.rms_norm(x, (D,), scale[0], RMS_EPS))
                 if shared else None, K.FWD_LOADS),
                ("bwd", bwd_err, bwd_tol, bwd_bound,
                 lambda: K.rmsnorm_bwd(x, scale, rstd, dy),
                 lambda: rmsnorm_bwd_ref(x, scale, rstd, dy), None,
                 K.BWD_LOADS)):
            k_ms = _time_ms(kern, iters)
            p_ms = _time_ms(plain, iters)
            if direction == "fwd":
                lib_ms = _time_ms(lib, iters) if lib else None
            else:
                lib_ms = _grad_ms(
                    lambda a, w: F.rms_norm(a, (D,), w[0], RMS_EPS),
                    (x, scale), dy, iters) if shared else None
            host_us, dev_us, per_call, names, events, _ = _host_and_device(
                kern, iters)
            if per_call != 1 or len(names) != 1:
                raise AssertionError(f"{tag} {direction}: {per_call} "
                                     f"kernels per call ({names}), not 1")
            tpr_log2, nl = K.layout(D // vec, vec > 1, loads)
            row = {"kernel": "rmsnorm" if direction == "fwd"
                   else "rmsnorm_bwd", "G": G, "R": R, "D": D, "dtype": dts,
                   "x_offset": off, "vector": vec,
                   "threads_per_row": 1 << tpr_log2, "loads": nl,
                   "max_abs_err": err, "tol": tol, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": lib_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "bound_share": bound[0] / k_ms, "device_us": dev_us,
                   "host_us": host_us, "launches_per_call": per_call,
                   "profiled": f"{events} kernel events over {iters} calls"}
            if direction == "bwd":
                row["tiles"] = K.tiles(G, R, tpr_log2)
                row["repeats_bitwise"] = True
            print("rmsnorm", json.dumps(row), flush=True)
            rows.append(row)
        if (G, R, D) == RMS_ZOO:
            layouts = _rms_layouts(K, x, scale, rstd, dy, {
                "fwd": (y_ref,), "bwd": (dx_ref,)})
            print("rmsnorm layouts", json.dumps(layouts), flush=True)
        del x, scale, dy, y, rstd, y_ref, rstd_ref, dx, ds, dx2, ds2
        del dx_ref, ds_ref
    _rms_host_pieces(K, torch)
    torch.cuda.empty_cache()
    return rows


# Flash-attention shapes (B, H, K, Sq, Sk, hd, causal, window, dtype): the
# transformer path's training call (20 satellites x 32 samples, 4 heads
# over 2 kv heads, 8 tokens, hd 8) and evaluation call (1000 samples), a
# short sweep for the short-sequence kernels (the GQA x mask cases at S = 8
# and 32, hd 8, a client batch of 32, f32 and bf16; at S = 32 the unit of 8
# heads over 1 is past `SHORT_BUDGET` and takes the older CUDA-core
# kernels), the short kernels' wider instantiations (padded hd 32, 64,
# 128 and 256 at S = 8, in float32, and in bfloat16 where the route is the
# CUDA cores', hd 32 and 256), the two sweeps of tests/test_kernels.py
# (GQA x mask at S=128, hd=64, in float32 and in bfloat16, the tensor
# cores' route; Sq/Sk x dtype at hd=128, unmasked), head dims the kernels
# do not instantiate (80 in bfloat16, padded to 128 on the tensor cores;
# 12 in float32, padded to 16 on the CUDA cores; 300 in bfloat16 with a
# window of 3 and 1,000 in float32, padded to 512 and 1,024 for the CUDA
# cores' row-looping kernels), and qwen3-8b's head layout at S=2048
# (configs/qwen3_8b.py).
FLASH_PATH = (640, 4, 2, 8, 8, 8, True, 0, "float32")
FLASH_EVAL = (1000, 4, 2, 8, 8, 8, True, 0, "float32")
FLASH_ZOO = (1, 32, 8, 2048, 2048, 128, True, 0, "bfloat16")
FLASH_SHORT_SWEEP = [(32, h, k, s, s, 8, causal, window, dt)
                     for s in (8, 32) for dt in ("float32", "bfloat16")
                     for h, k in ((4, 4), (4, 2), (8, 1))
                     for causal, window in ((True, 0), (True, 3),
                                            (False, 0))]
FLASH_SHORT_WIDE = [(32, 4, 2, 8, 8, hd, True, 0, dt) for hd, dt in (
    (32, "float32"), (32, "bfloat16"), (64, "float32"), (128, "float32"))] + [
    (32, 2, 2, 8, 8, 256, True, 0, dt) for dt in ("float32", "bfloat16")]
FLASH_SHAPES = [FLASH_PATH, FLASH_EVAL] + FLASH_SHORT_SWEEP \
    + FLASH_SHORT_WIDE + [
    (2, h, k, 128, 128, 64, causal, window, dt)
    for dt in ("float32", "bfloat16")
    for h, k in ((4, 4), (4, 2), (8, 1))
    for causal, window in ((True, 0), (True, 32), (False, 0))] + [
    (1, 2, 2, sq, sk, 128, False, 0, dt)
    for sq, sk in ((64, 64), (100, 200), (64, 192))
    for dt in ("float32", "bfloat16")] + [
    (1, 4, 2, 100, 200, 80, True, 0, "bfloat16"),
    (2, 4, 2, 64, 64, 12, True, 3, "float32"),
    (1, 4, 2, 128, 128, 300, True, 3, "bfloat16"),
    (1, 4, 2, 128, 128, 1000, True, 0, "float32"), FLASH_ZOO]
# The families phase's prefill calls, bf16: recurrentgemma-9b's local
# layers (16 query heads over 1 kv head of 256, the CUDA cores, S 4096
# past the 2,048 window), phi-3-vision's (32 heads of 96, zero-padded to
# 128 on the tensor cores), whisper-base's encoder (1,500 frames, no
# mask: a partial 64-row key tile), decoder self-attention (448 tokens,
# causal) and cross-attention (448 over 1,500, no mask).
FLASH_RG = (1, 16, 1, 4096, 4096, 256, True, 2048, "bfloat16")
FLASH_PHI3 = (1, 32, 32, 2048, 2048, 96, True, 0, "bfloat16")
FLASH_WHISPER_ENC = (8, 8, 8, 1500, 1500, 64, False, 0, "bfloat16")
FLASH_WHISPER_DEC = (8, 8, 8, 448, 448, 64, True, 0, "bfloat16")
FLASH_WHISPER_CROSS = (8, 8, 8, 448, 1500, 64, False, 0, "bfloat16")
FLASH_FAMILIES = [FLASH_RG, FLASH_PHI3, FLASH_WHISPER_ENC, FLASH_WHISPER_DEC,
                  FLASH_WHISPER_CROSS]
FLASH_SHAPES += FLASH_FAMILIES
# The hd-256 tensor-core backward's rows, bf16 (its forward "tc256" too):
# gemma3-12b's local layers at hd 240 (16 heads over 8 kv heads, window
# 1,024; configs/gemma3_12b.py) at one microbatch of train_4k (B 1 x S
# 4096), and a GQA x mask sweep at hd 256 (16 and 4 heads over 1, 4 over
# 2; causal, a window of 64, no mask; Sq != Sk both ways, hd 240 once),
# with recurrentgemma-9b's train call, `FLASH_RG`, above
FLASH_GEMMA_TRAIN = (1, 16, 8, 4096, 4096, 240, True, 1024, "bfloat16")
FLASH_BWD256_SWEEP = [(2, h, k, 200, 200, 256, causal, window, "bfloat16")
                      for h, k in ((16, 1), (4, 1), (4, 2))
                      for causal, window in ((True, 0), (True, 64),
                                             (False, 0))] + [
    (1, 4, 2, 100, 170, 256, True, 0, "bfloat16"),
    (1, 4, 2, 170, 100, 240, True, 32, "bfloat16")]
FLASH_SHAPES += [FLASH_GEMMA_TRAIN] + FLASH_BWD256_SWEEP
# The zoo tp phase's prefill and train calls of a rank at a model axis of
# 2 (its query heads and the kv heads they read), each at S 2048, causal:
# qwen3-8b's 16 over 4 in bf16, qwen3-moe-30b-a3b's 16 over 2 in float32
FLASH_TP = (1, 16, 4, 2048, 2048, 128, True, 0, "bfloat16")
FLASH_TP_MOE = (1, 16, 2, 2048, 2048, 128, True, 0, "float32")
FLASH_SHAPES += [FLASH_TP, FLASH_TP_MOE]
# head groups of the hd-256 backward timed at FLASH_RG (the wrapper picks
# one of them, `kernel.bwd_groups`)
BWD256_GROUPS = (1, 2, 4, 8, 16)
TC_KERNEL = "flash_fwd_tc_kernel"     # in the tensor-core kernel's name
TC256_KERNEL = "flash_fwd_tc256_kernel"   # in the hd-256 one's
COMBINE_KERNEL = "flash_combine_kernel"   # in its combine's
TC_BWD_KERNELS = ("flash_bwd_tc_delta_kernel", "flash_bwd_tc_dkdv_kernel",
                  "flash_bwd_tc_dq_kernel")   # in the backward's
TC256_BWD_KERNELS = ("flash_bwd_tc256_delta_kernel",   # in the hd-256
                     "flash_bwd_tc256_dkdv_kernel",    # backward's (the
                     "flash_bwd_tc256_dq_kernel")      # merge's apart)
TC256_MERGE_KERNEL = "flash_bwd_tc256_merge_kernel"
SHORT_KERNELS = {"fwd": "flash_fwd_short_kernel",   # in the short-sequence
                 "bwd": "flash_bwd_short_kernel"}   # kernels' names


def _cuda_core_fwd(K, q, k, v, causal, window):
    """The CUDA-core forward called through its C entry point, whatever
    route the wrapper would pick, on inputs zero-padded as the wrapper
    pads them (not counted)."""
    import torch
    hd = q.shape[-1]
    width = K.padded_head_dim(hd)
    q, k, v = (K.pad_head_dim(t, width) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = K._library()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(),
                          *K._dims(q, k, causal, window, hd))
    if err:
        raise RuntimeError(f"flash_fwd_launch failed with cudaError {err}")
    return o[..., :hd], lse


def _tc256_direct(K, q, k, v, causal, window, splits, combine=True):
    """The hd-256 tensor-core forward (and, split, its combine) set up for
    `splits` splits on (B, H, S, hd) inputs padded as the wrapper pads
    them, with its outputs and workspaces allocated once: a function that
    launches it through its C entry points (not counted; with `combine`
    False the forward alone), o, lse and the split workspaces (o_part,
    lse_part), or None unsplit."""
    import torch
    hd = q.shape[-1]
    q, k, v = (K.pad_head_dim(t, 256) for t in (q, k, v))
    sizes = K._sizes(q, k, False)
    B, H, _, Sq, _ = sizes
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    parts = () if splits == 1 else (
        torch.empty((splits, B, H, Sq, 256), dtype=torch.float32,
                    device=q.device),
        torch.empty((splits, B, H, Sq), dtype=torch.float32,
                    device=q.device))
    args = K._tc256_args((q, k, v, o, lse), [t.data_ptr() for t in parts],
                         sizes, causal, window, splits, hd, False)
    fwd, comb = K._library_tc256()
    entries = ((fwd, "flash_fwd_tc256_launch"),) + (
        ((comb, "flash_combine_launch"),) if combine and parts else ())

    def run():
        for fn, name in entries:
            err = fn(args)
            if err:
                raise RuntimeError(f"{name} failed with cudaError {err}")
    return run, o[..., :hd], lse, (parts or None)


def _combine_direct(K, o, lse, parts, splits):
    """The combine alone of the split workspaces `parts` into o (B, H,
    Sq, hd) and lse, its argument block built once: a function that
    launches it through its C entry point (not counted)."""
    args = K._tc256_args((o, o, o, o, lse), [t.data_ptr() for t in parts],
                         K._sizes(o, o, False), False, 0, splits,
                         o.shape[-1], False)
    comb = K._library_tc256()[1]

    def run():
        err = comb(args)
        if err:
            raise RuntimeError(f"flash_combine_launch failed with "
                               f"cudaError {err}")
    return run


def _bwd_direct(K, q, k, v, o, lse, do, causal, window, parts=None):
    """A backward called through its C entry point, not counted, on inputs
    zero-padded as the wrapper pads them: the CUDA-core kernels, or with
    `parts` the tensor-core kernels with P and dS in that many bf16
    parts."""
    import torch
    hd = q.shape[-1]
    width = K.padded_head_dim(hd)
    q, k, v, o, do = (K.pad_head_dim(t, width) for t in (q, k, v, o, do))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    launch, extra = ((K._library()[1], ()) if parts is None
                     else (K._library_bwd_tc(), (parts,)))
    err = launch(*(t.data_ptr() for t in (q, k, v, o, lse, do, *grads,
                                          delta)),
                 *K._dims(q, k, causal, window, hd), *extra)
    if err:
        raise RuntimeError(f"backward launch failed with cudaError {err}")
    return [t[..., :hd] for t in grads]


def _tc256_bwd_direct(K, q, k, v, o, lse, do, causal, window, groups,
                      parts):
    """The hd-256 tensor-core backward set up for `groups` head groups and
    P and dS in `parts` bf16 parts on (B, H, S, hd) inputs padded as the
    wrapper pads them, outputs and workspaces allocated once: a function
    that launches it through its C entry point (not counted), and dq, dk,
    dv at the true head dim."""
    import torch
    hd = q.shape[-1]
    q, k, v, o, do = (K.pad_head_dim(t, 256) for t in (q, k, v, o, do))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    sizes = K._sizes(q, k, False)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    part, ws = K._group_parts(q, sizes, groups)
    args = K._tc256_bwd_args((q, k, v, o, lse, do, *grads, delta), part,
                             sizes, causal, window, groups, parts, hd, False)
    fn = K._library_bwd_tc256()

    def run(_ws=ws):          # the workspace lives as long as the function
        err = fn(args)
        if err:
            raise RuntimeError(f"flash_bwd_tc256_launch failed with "
                               f"cudaError {err}")
    return run, [t[..., :hd] for t in grads]


def _errs(outs, refs, dtype):
    """(largest |kernel - plain|, largest share of the tolerance
    |kernel - plain| / (atol + rtol |plain|)) over outputs, without
    failing: above 1 a check would fail."""
    rtol, atol = _tol(dtype, grad=True)
    diffs = [((o.float() - r.float()).abs(), r.float().abs())
             for o, r in zip(outs, refs)]
    return (max(d.max().item() for d, _ in diffs),
            max((d / (atol + rtol * m)).max().item() for d, m in diffs))


def _tc256_bwd_kernels(names, groups, unpadded, per_call):
    """Whether the kernels seen are the hd-256 backward's: delta, dk/dv and
    dq once each, the merge once where it splits into head groups, and
    besides them (at a padded hd) only the wrapper's pad and slice
    copies; at hd 256 nothing else, one call that many kernels."""
    ours = TC256_BWD_KERNELS + ((TC256_MERGE_KERNEL,) if groups > 1 else ())
    if not all(sum(t in n for n in names) == 1 for t in ours) or any(
            TC256_MERGE_KERNEL in n for n in names) != (groups > 1):
        return False
    others = [n for n in names if not any(t in n for t in ours)]
    if unpadded:
        return not others and per_call == len(ours)
    return all(_is_copy_kernel(n) or "Fill" in n for n in others)


def _tc256_bwd_row(K, row, tag, shape, q, k, v, o, lse, do, grads,
                   grads_ref, causal, window, iters):
    """A row of the hd-256 tensor-core backward: its head groups; a second
    call bit for bit the first; P and dS in one bf16 part and in two
    (errors against the plain backward, and at `FLASH_RG` and
    `FLASH_GEMMA_TRAIN` their times); there also the CUDA-core backward on
    the same inputs through its C entry point (the route this replaced),
    checked and timed, and at `FLASH_RG` each head-group count of
    `BWD256_GROUPS` that divides G, checked and timed."""
    import torch
    B, H, KH, sq, sk = shape[:5]
    dt = q.dtype
    kw = dict(causal=causal, window=window)
    groups = K._call_groups((B, H, KH, sq, sk), q.get_device())
    again = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{tag} bwd: two calls differ")
    row.update(groups=groups, bit_equal_two_calls=True,
               bwd_tc_parts=K.BWD_TC_PARTS)
    runs = {}
    for parts in (1, 2):
        run, out = _tc256_bwd_direct(K, q, k, v, o, lse, do, causal, window,
                                     groups, parts)
        run()
        runs[parts] = run
        e = _errs(out, grads_ref, dt)
        row.setdefault("max_abs_err_by_parts", {})[parts] = e[0]
        row.setdefault("tol_share_by_parts", {})[parts] = e[1]
    if shape not in (FLASH_RG, FLASH_GEMMA_TRAIN):
        return
    row["ms_by_parts"] = {p: _time_ms(r, iters) for p, r in runs.items()}
    cc = _bwd_direct(K, q, k, v, o, lse, do, causal, window)
    _compare(tag + " bwd cuda-core", cc, grads_ref, dt, grad=True)
    row["cuda_core_ms"] = _time_ms(
        lambda: _bwd_direct(K, q, k, v, o, lse, do, causal, window),
        max(2, iters // 5))
    if shape != FLASH_RG:
        return
    for d in BWD256_GROUPS:
        if (H // KH) % d:
            continue
        run, out = _tc256_bwd_direct(K, q, k, v, o, lse, do, causal, window,
                                     d, K.BWD_TC_PARTS)
        run()
        _compare(f"{tag} bwd groups {d}", out, grads_ref, dt, grad=True)
        row.setdefault("ms_by_groups", {})[d] = _time_ms(run, iters)


def _tc_bwd_kernels(names):
    """Whether the kernels seen are the three of the tensor-core backward,
    each once."""
    return len(names) == 3 and all(
        sum(t in n for n in names) == 1 for t in TC_BWD_KERNELS)


def _short_row(K, row, tag, direction, kern, iters, q, k, v, o, lse, do,
               kw, fwd_ref, grads_ref, dt):
    """A row of the short-sequence kernels: their device and host time per
    call (one kernel a call, either direction, checked), and the older
    CUDA-core kernels on the same inputs through their C entry points (not
    counted), checked against the plain version and timed, with their
    device time and kernels per call."""
    host_us, dev_us, per_call, names, events, by_name = _host_and_device(
        kern, iters)
    if per_call != 1 or len(names) != 1 or \
            SHORT_KERNELS[direction] not in names[0]:
        raise AssertionError(f"{tag} {direction}: {per_call} kernels per "
                             f"call ({names}), not one short kernel")
    row.update(device_us=dev_us, host_us=host_us, launches_per_call=per_call,
               kernels_seen=names, device_us_by_kernel=by_name,
               profiled=f"{events} kernel events over {iters} calls")
    causal, window = kw["causal"], kw["window"]
    if direction == "fwd":
        def old():
            return _cuda_core_fwd(K, q, k, v, causal, window)
        _compare(tag + " cuda-core", old()[:1], fwd_ref[:1], dt)
    else:
        def old():
            return _bwd_direct(K, q, k, v, o, lse, do, causal, window)
        _compare(tag + " bwd cuda-core", old(), grads_ref, dt, grad=True)
    row["cuda_core_ms"] = _time_ms(old, iters)
    _, dev_old, per_old, _, _, by_old = _host_and_device(old, iters)
    row.update(cuda_core_device_us=dev_old,
               cuda_core_launches_per_call=per_old,
               cuda_core_device_us_by_kernel=by_old)


def check_flash(torch):
    """Phase 3: flash attention forward and backward against the plain
    version."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (_mask,
                                                         attention_bwd_ref,
                                                         attention_fwd_ref)
    from repro_torch.kernels import launch_counts
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape in FLASH_SHAPES:
        B, H, KH, sq, sk, hd, causal, window, dts = shape
        dt = getattr(torch, dts)
        q = torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        do = torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        route = K.route(dt, K.padded_head_dim(hd))
        short = K.short_fits(H // KH, sq, sk, K.padded_head_dim(hd), dt)
        fwd_route = K.forward_route(H // KH, sq, sk, K.padded_head_dim(hd),
                                    dt)
        bwd_route = K.backward_route(H // KH, sq, sk,
                                     K.padded_head_dim(hd), dt)
        splits = (K._call_splits((B, H, KH, sq, sk), causal, q.get_device())
                  if fwd_route == "tc256" else 1)
        before = dict(launch_counts)
        o, lse = K.flash_attention(q, k, v, **kw)
        o_ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, want in ((K.NAME_TC, route == "tc"),
                           (K.NAME_BWD_TC, route == "tc"),
                           (K.NAME_TC256, fwd_route == "tc256"),
                           (K.NAME_COMBINE, splits > 1),
                           (K.NAME_BWD_TC256, bwd_route == "tc256"),
                           (K.NAME_SHORT, short), (K.NAME_BWD_SHORT, short)):
            if launch_counts[name] - before.get(name, 0) != want:
                raise AssertionError(f"{shape}: route {route}, short "
                                     f"{short}, forward {fwd_route}, "
                                     f"backward {bwd_route}, but "
                                     f"{launch_counts[name]} {name} "
                                     f"launches")
        # the plain backward starts from the plain forward's o and lse
        grads_ref = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        torch.cuda.synchronize()
        tag = (f"flash B={B} H={H} K={KH} Sq={sq} Sk={sk} hd={hd} "
               f"causal={causal} window={window} {dts}")
        fwd_err, fwd_tol = _compare(tag, (o,), (o_ref,), dt)
        lse_err, _ = _compare(tag + " lse", (lse,), (lse_ref,),
                              torch.float32)
        fwd_err = max(fwd_err, lse_err)
        bwd_err, bwd_tol = _compare(tag + " bwd", grads, grads_ref, dt,
                                    grad=True)
        big = sq * sk * B * H >= 1 << 24
        iters = 10 if big else 50 if shape in (
            FLASH_SHORT_SWEEP + FLASH_SHORT_WIDE + FLASH_BWD256_SWEEP) \
            else 100
        work = (B, H, KH, sq, sk, hd, q.element_size(), causal, window)
        fwd_bound = cost.bound(*cost.flash(*work), cost.BF16_TC_FLOP_PER_S)
        bwd_bound = cost.bound(*cost.flash(*work, backward=True),
                               cost.BF16_TC_FLOP_PER_S)
        # one PyTorch call computing the same function (no row here is
        # fully masked, where SDPA and the kernel differ)
        mask = _mask(sq, sk, causal, window, q.device) if window else None

        def sdpa(a, b_, c):
            return F.scaled_dot_product_attention(
                a, b_, c, attn_mask=mask, is_causal=causal and not window,
                enable_gqa=True)
        for direction, err, tol, bound, kern, plain in (
                ("fwd", fwd_err, fwd_tol, fwd_bound,
                 lambda: K.flash_attention(q, k, v, **kw),
                 lambda: attention_fwd_ref(q, k, v, **kw)),
                ("bwd", bwd_err, bwd_tol, bwd_bound,
                 lambda: K.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                 lambda: attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                           **kw))):
            k_ms = _time_ms(kern, iters)
            p_ms = _time_ms(plain, iters)
            lib_ms = (_time_ms(lambda: sdpa(q, k, v), iters)
                      if direction == "fwd"
                      else _grad_ms(sdpa, (q, k, v), do, iters))
            row = {"kernel": "flash_attention" if direction == "fwd"
                   else "flash_attention_bwd", "B": B, "H": H, "K": KH,
                   "Sq": sq, "Sk": sk, "hd": hd, "causal": causal,
                   "window": window, "dtype": dts,
                   "route": fwd_route if direction == "fwd" else bwd_route,
                   "max_abs_err": err,
                   "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": bound[0],
                   "bound_by": bound[1], "bound_share": bound[0] / k_ms}
            if fwd_route == "tc256":
                row["splits"] = splits
            if shape in (FLASH_ZOO, FLASH_RG) and direction == "fwd":
                # the CUDA-core forward on the same inputs, launched through
                # its C entry point (not counted): the route this replaced
                # (at hd 256 until the hd-256 tensor-core forward)
                cc = _cuda_core_fwd(K, q, k, v, causal, window)
                _compare(tag + " cuda-core", cc[:1], (o_ref,), dt)
                row["cuda_core_ms"] = _time_ms(
                    lambda: _cuda_core_fwd(K, q, k, v, causal, window), iters)
            if direction == "bwd" and route == "tc":
                # P and dS in one bf16 part and in two, through the C entry
                # point (not counted), against the same plain backward
                row["bwd_tc_parts"] = K.BWD_TC_PARTS
                errs = {parts: _errs(_bwd_direct(K, q, k, v, o, lse, do,
                                                 causal, window, parts),
                                     grads_ref, dt) for parts in (1, 2)}
                row["max_abs_err_by_parts"] = {p: e[0]
                                               for p, e in errs.items()}
                row["tol_share_by_parts"] = {p: e[1]
                                             for p, e in errs.items()}
            if direction == "bwd" and bwd_route == "tc256":
                _tc256_bwd_row(K, row, tag, shape, q, k, v, o, lse, do,
                               grads, grads_ref, causal, window, iters)
            if shape == FLASH_ZOO and direction == "bwd":
                # the CUDA-core backward on the same inputs, and the other
                # number of parts: the route and the design this replaced
                cc = _bwd_direct(K, q, k, v, o, lse, do, causal, window)
                _compare(tag + " bwd cuda-core", cc, grads_ref, dt,
                         grad=True)
                row["cuda_core_ms"] = _time_ms(
                    lambda: _bwd_direct(K, q, k, v, o, lse, do, causal,
                                        window), iters)
                row["ms_by_parts"] = {parts: _time_ms(
                    lambda: _bwd_direct(K, q, k, v, o, lse, do, causal,
                                        window, parts), iters)
                    for parts in (1, 2)}
            if short:
                _short_row(K, row, tag, direction, kern, iters, q, k, v, o,
                           lse, do, kw, (o_ref, lse_ref), grads_ref, dt)
            if (shape in (FLASH_PATH, FLASH_ZOO, FLASH_RG) and not short) \
                    or (shape == FLASH_GEMMA_TRAIN and direction == "bwd"):
                host_us, dev_us, per_call, names, events, by_name = \
                    _host_and_device(kern, iters)
                row.update(device_us=dev_us, host_us=host_us,
                           launches_per_call=per_call, kernels_seen=names,
                           device_us_by_kernel=by_name,
                           profiled=f"{events} kernel events over {iters} "
                                    f"calls")
                if direction == "fwd" and (
                        per_call != 1 or len(names) != 1
                        or (TC_KERNEL in names[0]) != (route == "tc")
                        or (TC256_KERNEL in names[0])
                        != (fwd_route == "tc256")):
                    raise AssertionError(f"{tag}: {per_call} kernels per "
                                         f"call ({names}), not one "
                                         f"{fwd_route} kernel")
                if direction == "bwd" and route == "tc" and (
                        per_call != 3 or not _tc_bwd_kernels(names)):
                    raise AssertionError(f"{tag}: {per_call} kernels per "
                                         f"call ({names}), not the three "
                                         f"tensor-core backward kernels")
                if direction == "bwd" and bwd_route == "tc256" and \
                        not _tc256_bwd_kernels(names, row["groups"],
                                               hd == 256, per_call):
                    raise AssertionError(f"{tag}: {per_call} kernels per "
                                         f"call ({names}), not the hd-256 "
                                         f"backward's")
            print("flash", json.dumps(row), flush=True)
            rows.append(row)
        del q, k, v, do, o, lse, o_ref, lse_ref, grads, grads_ref
    torch.cuda.empty_cache()
    return rows


# The zoo's decode calls, forward only (serving takes no
# gradient), non-causal over the cache's prefix: qwen3-8b's heads at B 8
# as one query against Sk keys (the layout a decode step has, G = 4 query
# heads a kv head), the same calls as the path makes them (the G query
# heads of a kv head as G query rows of one head: (B, K, G, hd) against
# (B, K, Sk, hd)), gemma3-12b's hd 240 (padded to 256, the CUDA cores) in
# the path's form, and the reduced float32 configs' (4 heads over 2, hd
# 64: the short kernels).
FLASH_DECODE_ONE = [(8, 32, 8, 1, sk, 128, False, 0, "bfloat16")
                    for sk in (1, 2, 63, 64, 65, 257, 512, 576)]
FLASH_DECODE_PATH = (8, 8, 8, 4, 576, 128, False, 0, "bfloat16")
FLASH_DECODE = FLASH_DECODE_ONE + [
    (8, 8, 8, 4, sk, 128, False, 0, "bfloat16") for sk in (1, 64, 65, 512)] \
    + [FLASH_DECODE_PATH, (8, 8, 8, 2, 576, 240, False, 0, "bfloat16"),
       (4, 2, 2, 2, 31, 64, False, 0, "float32")]
# The families phase's decode calls at B 8, bf16, each as the path makes
# it: recurrentgemma-9b's 16 query heads of its one kv head as 16 rows
# (hd 256, the CUDA cores) over the serve loop's last prefix (160) and a
# full window (2,048); phi-3-vision's one query a head over 160 (hd 96
# padded to 128); whisper-base's self-attention over its last prefix
# (64) and cross-attention over the 1,500 encoder frames.
FLASH_DECODE_RG = (8, 1, 1, 16, 2048, 256, False, 0, "bfloat16")
FLASH_DECODE_FAMILIES = [(8, 1, 1, 16, 160, 256, False, 0, "bfloat16"),
                         FLASH_DECODE_RG,
                         (8, 32, 32, 1, 160, 96, False, 0, "bfloat16"),
                         (8, 8, 8, 1, 64, 64, False, 0, "bfloat16"),
                         (8, 8, 8, 1, 1500, 64, False, 0, "bfloat16")]
FLASH_DECODE += FLASH_DECODE_FAMILIES
# The zoo tp phase's decode call of a rank at a model axis of 2, at its
# serve loop's last step: qwen3-8b's 4 kv heads a rank, the 4 query heads
# of each as 4 rows, over a prefix of 8
FLASH_DECODE_TP = (8, 4, 4, 4, 8, 128, False, 0, "bfloat16")
FLASH_DECODE += [FLASH_DECODE_TP]


# Splits over keys timed beside the chosen count at recurrentgemma-9b's
# full-window decode call (`flash decode` row's `ms_by_splits`)
DECODE_SPLITS_SWEEP = (1, 4, 8, 16, 32, 64)


def _split_checks(torch, K, row, tag, q, k, v, kw, splits, iters):
    """A split decode call's parts on the hd-256 tensor-core route, through
    the C entry points (not counted): the splits' partial o and lse
    against `attention_fwd_split_ref` over the same key ranges, the
    combine against `combine_splits_ref` of those partials (its own row,
    returned), and the forward's time at each count of
    `DECODE_SPLITS_SWEEP`."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_fwd_split_ref, combine_splits_ref)
    B, H, sq, _ = q.shape
    sk = k.shape[2]
    dt = q.dtype
    run, _, _, (o_part, lse_part) = _tc256_direct(
        K, q, k, v, kw["causal"], kw["window"], splits, combine=False)
    run()
    ranges = K.split_ranges(0, min(sk, sq) if kw["causal"] else sk, splits)
    pw = [K.pad_head_dim(t, 256) for t in (q, k, v)]
    o_ref, lse_ref = attention_fwd_split_ref(*pw, ranges, scale=q.shape[-1]
                                             ** -0.5, **kw)
    torch.cuda.synchronize()
    part_err = max(_compare(tag + " split o", (o_part,), (o_ref,), dt)[0],
                   _compare(tag + " split lse", (lse_part,), (lse_ref,),
                            torch.float32)[0])
    row.update(split_max_abs_err=part_err, split_ranges=ranges[:4])
    out = torch.empty(B, H, sq, 256, dtype=dt, device=q.device)
    out_lse = torch.empty(B, H, sq, dtype=torch.float32, device=q.device)
    comb = _combine_direct(K, out, out_lse, (o_part, lse_part), splits)
    comb()
    c_ref, c_lse = combine_splits_ref(o_part, lse_part)
    torch.cuda.synchronize()
    c_err = max(_compare(tag + " combine", (out,), (c_ref,), dt)[0],
                _compare(tag + " combine lse", (out_lse,), (c_lse,),
                         torch.float32)[0])
    bound = cost.bound(*cost.flash_combine(splits, B * H * sq, 256,
                                           q.element_size()),
                       cost.FP32_FLOP_PER_S)
    c_row = {"kernel": "flash_combine", "B": B, "H": H, "Sq": sq,
             "splits": splits, "hd": 256, "dtype": str(dt).split(".")[-1],
             "max_abs_err": c_err, "tol": _tol(dt),
             "kernel_ms": _time_ms(comb, iters),
             "plain_ms": _time_ms(lambda: combine_splits_ref(o_part,
                                                             lse_part),
                                  iters),
             "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1]}
    c_row["bound_share"] = c_row["bound_ms"] / c_row["kernel_ms"]
    # the forward and its combine launched alone at each count, outputs
    # allocated once: the device's time, not the wrapper's host time
    row["ms_by_splits"] = {n: _time_ms(_tc256_direct(
        K, q, k, v, kw["causal"], kw["window"], n)[0], iters)
        for n in DECODE_SPLITS_SWEEP}
    return c_row


def check_flash_decode(torch):
    """Phase 3: the decode calls' forward against the plain version, with
    SDPA's time beside it, the route checked against the launch counts;
    at the path's last step (Sk 576) also its device time and kernels a
    call. The calls on the hd-256 tensor-core route have the CUDA-core
    forward's time on the same inputs beside them, and their splits; at
    recurrentgemma-9b's full window also the splits' partial results and
    the combine held apart (a `flash combine` row), the device time and
    kernels a call, and the time at other split counts."""
    import torch.nn.functional as F
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for shape in FLASH_DECODE:
        B, H, KH, sq, sk, hd, causal, window, dts = shape
        dt = getattr(torch, dts)
        q = torch.randn(B, H, sq, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, KH, sk, hd, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        width = K.padded_head_dim(hd)
        route = K.route(dt, width)
        short = K.short_fits(H // KH, sq, sk, width, dt)
        fwd_route = K.forward_route(H // KH, sq, sk, width, dt)
        splits = (K._call_splits((B, H, KH, sq, sk), causal, q.get_device())
                  if fwd_route == "tc256" else 1)
        before = dict(launch_counts)
        o, lse = K.flash_attention(q, k, v, **kw)
        for name, want in ((K.NAME_TC, route == "tc"),
                           (K.NAME_SHORT, short),
                           (K.NAME_TC256, fwd_route == "tc256"),
                           (K.NAME_COMBINE, splits > 1)):
            if launch_counts[name] - before.get(name, 0) != want:
                raise AssertionError(f"{shape}: route {route}, short "
                                     f"{short}, forward {fwd_route}, but "
                                     f"{launch_counts[name]} {name} "
                                     f"launches")
        o_ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = (f"flash decode B={B} H={H} K={KH} Sq={sq} Sk={sk} hd={hd} "
               f"{dts}")
        err, tol = _compare(tag, (o,), (o_ref,), dt)
        err = max(err, _compare(tag + " lse", (lse,), (lse_ref,),
                                torch.float32)[0])
        bound = cost.bound(*cost.flash(B, H, KH, sq, sk, hd,
                                       q.element_size(), False, 0),
                           cost.BF16_TC_FLOP_PER_S)
        row = {"kernel": "flash_attention", "B": B, "H": H, "K": KH,
               "Sq": sq, "Sk": sk, "hd": hd, "causal": causal,
               "window": window, "dtype": dts, "route": fwd_route,
               "max_abs_err": err, "tol": tol,
               "kernel_ms": _time_ms(lambda: K.flash_attention(q, k, v, **kw),
                                     100),
               "plain_ms": _time_ms(lambda: attention_fwd_ref(q, k, v, **kw),
                                    100),
               "library_ms": _time_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, enable_gqa=True), 100),
               "bound_ms": bound[0], "bound_by": bound[1]}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        if fwd_route == "tc256":
            # the CUDA-core forward on the same inputs (not counted): the
            # route these calls took before
            cc = _cuda_core_fwd(K, q, k, v, causal, window)
            _compare(tag + " cuda-core", cc[:1], (o_ref,), dt)
            row.update(splits=splits, cuda_core_ms=_time_ms(
                lambda: _cuda_core_fwd(K, q, k, v, causal, window), 100))
        if shape == FLASH_DECODE_RG:
            c_row = _split_checks(torch, K, row, tag, q, k, v, kw, splits,
                                  100)
            print("flash combine", json.dumps(c_row), flush=True)
            rows.append(c_row)
            host_us, dev_us, per_call, names, events, by_name = \
                _host_and_device(lambda: K.flash_attention(q, k, v, **kw),
                                 100)
            if per_call != 2 or len(names) != 2 or not all(
                    any(n in x for x in names)
                    for n in (TC256_KERNEL, COMBINE_KERNEL)):
                raise AssertionError(f"{tag}: {per_call} kernels per call "
                                     f"({names}), not the hd-256 forward "
                                     f"and its combine")
            row.update(device_us=dev_us, host_us=host_us,
                       launches_per_call=per_call, kernels_seen=names,
                       device_us_by_kernel=by_name,
                       profiled=f"{events} kernel events over 100 calls")
        if shape == FLASH_DECODE_PATH:
            host_us, dev_us, per_call, names, events, _ = _host_and_device(
                lambda: K.flash_attention(q, k, v, **kw), 100)
            if per_call != 1 or len(names) != 1 or TC_KERNEL not in names[0]:
                raise AssertionError(f"{tag}: {per_call} kernels per call "
                                     f"({names}), not one tensor-core kernel")
            row.update(device_us=dev_us, host_us=host_us,
                       launches_per_call=per_call, kernels_seen=names,
                       profiled=f"{events} kernel events over 100 calls")
        print("flash decode", json.dumps(row), flush=True)
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def quickstart_experiment():
    """The FedBuff row of examples/quickstart.py at its full size."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="quickstart",
        constellation=ConstellationConfig(num_satellites=40, days=3.0),
        dataset=DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=12,
                           target_acc=0.35, max_windows=288))


class LoopStats:
    """What a block of engine runs cost the host: the fast loop's CUDA
    graphs captured and replayed (`repro_torch.fl.engine.graph_counts`)
    and the synchronizing calls torch saw under
    `torch.cuda.set_sync_debug_mode("warn")` (device-to-host reads, and
    copies from pageable host memory, which wait for the device too)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import warnings
        from repro_torch.fl.engine import graph_counts
        self._before = dict(graph_counts)
        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.synchronize()
        self.torch.cuda.set_sync_debug_mode("warn")
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from repro_torch.fl.engine import graph_counts
        self.torch.cuda.synchronize()
        self.wall = time.perf_counter() - self._t0
        self.torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)
        self.syncs = sum("synchroniz" in str(w.message)
                         for w in self._caught)
        self.captures = graph_counts["captures"] - self._before["captures"]
        self.replays = graph_counts["replays"] - self._before["replays"]

    def line(self, eng):
        """The block's numbers with the engine's own counts (chunks,
        scans, its device-to-host reads)."""
        return {"wall_s": round(self.wall, 3), **eng.loop_counts,
                "captures": self.captures, "replays": self.replays,
                "syncs": self.syncs}


def _engine(fed, init_params=None, callbacks=(), **overrides):
    """`fed.engine()` on the world's device with `overrides` of its
    `EngineConfig` (`fast_loop=False`, `max_windows`, ...)."""
    import dataclasses
    from repro_torch.fl.engine import SimulationEngine
    cfg = dataclasses.replace(fed.engine(device=fed.device).config,
                              **overrides)
    return SimulationEngine(fed.C, fed.adapter, fed.scheduler, cfg,
                            callbacks=callbacks, init_params=init_params,
                            device=fed.device,
                            link_budget=fed.link_budget, isl=fed.isl,
                            faults=fed.faults)


def _strategies(torch, tag, fed, fast_eng, fast_res, fast_stats,
                init_params=None, fast_replans=None):
    """The card's host-loop run of `fed` beside its fast-loop run (done):
    every counter, the staleness histogram, the evaluation windows, the
    protocol columns and the final params bit for bit (one device, the
    same operations), and with `fast_replans` (the fast run's `Replans`
    log) every re-plan's schedule; one aggregation launch per aggregation
    on each; the walls, chunks, graph captures and replays and device
    reads of both printed. Returns the host run's stats."""
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_leaves
    if not fast_eng._fast_ok or fast_eng.loop_counts["chunks"] == 0:
        raise AssertionError(f"{tag}: the default run took no fast loop")
    if fast_stats.replays != fast_eng.loop_counts["scans"]:
        raise AssertionError(f"{tag}: {fast_stats.replays} graph replays "
                             f"for {fast_eng.loop_counts['scans']} scans")
    host_eng = _engine(fed, init_params, fast_loop=False)
    launch_counts.clear()
    with LoopStats(torch) as host_stats, Replans() as host_replans:
        host = host_eng.run()
    _one_launch_per_aggregation(host, dict(launch_counts))
    if fast_replans is not None:
        _same_schedules(fast_replans, host_replans.log)
    if host_eng.loop_counts["chunks"] or host_stats.replays:
        raise AssertionError(f"{tag}: the host loop ran chunks")
    _same_counters(fast_res, host)
    if _columns(fast_eng) != _columns(host_eng):
        raise AssertionError(f"{tag}: protocol columns differ, fast loop "
                             f"against host loop")
    if fast_res.accuracy != host.accuracy or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(fast_eng.params),
                                              tree_leaves(host_eng.params))):
        raise AssertionError(f"{tag}: params or accuracies differ, fast "
                             f"loop against host loop on the card")
    print(f"{tag} strategies (cuda): fast loop "
          f"{json.dumps(fast_stats.line(fast_eng))}, host loop "
          f"{json.dumps(host_stats.line(host_eng))}; counters, histogram, "
          f"columns and params bit for bit", flush=True)
    return host_stats


def run_main_path(torch):
    """Phase 4, the quickstart path: the card's run (the fast loop, the
    default), the card's host-loop run held to it bit for bit, then the
    CPU's. Returns the launch counts of the card's fast-loop run."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    exp = quickstart_experiment()
    launch_counts.clear()
    t0 = time.perf_counter()
    fed = Federation.from_experiment(exp)
    with LoopStats(torch) as stats:
        eng = fed.engine()
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print("main path (cuda):", json.dumps(res.summary()), flush=True)
    print(f"main path (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts}", flush=True)
    _one_launch_per_aggregation(res, counts)
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    _strategies(torch, "main path", fed, eng, res, stats)

    t0 = time.perf_counter()
    cpu = Federation.from_experiment(exp, device="cpu").run()
    print("main path (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    # accuracy counts argmax hits on 1000 validation samples; float32
    # products summed in another order on the card may flip a few of them
    _close_accuracy(res, cpu, 0.01)
    return counts


def _one_launch_per_aggregation(res, counts):
    updates = res.num_global_updates
    if updates == 0 or counts.get("weighted_aggregate") != updates:
        raise AssertionError(f"expected one agg launch per aggregation "
                             f"({updates} aggregations), got {counts}")


def _same_counters(res, cpu):
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run",
                 "eval_windows"):
        if getattr(res, name) != getattr(cpu, name):
            raise AssertionError(f"{name}: card {getattr(res, name)} vs "
                                 f"CPU {getattr(cpu, name)}")
    if res.staleness_hist.tolist() != cpu.staleness_hist.tolist():
        raise AssertionError("staleness histograms differ")


def _close_accuracy(res, cpu, tol):
    acc_err = abs(res.accuracy[-1] - cpu.accuracy[-1])
    print(f"final accuracy: card {res.accuracy[-1]} CPU {cpu.accuracy[-1]}"
          f" (|diff| {acc_err}, tolerance {tol})", flush=True)
    if acc_err > tol:
        raise AssertionError("final accuracy differs beyond tolerance")


FASTLOOP_MODES = (("fedbuff", {"M": FAULT_M}, None),
                  ("intra_plane", {"M": FAULT_M}, "sink"),
                  ("isl_async", {}, "gossip"))
# buckets 1-128 all run in the `gpu` test of the graph replay
# (tests/test_torch_device.py); the script holds and times three of them
# and stops at two windows, which leaves its time room for the mesh phase
FASTLOOP_BUCKETS = (1, 8, 128)
FASTLOOP_STOPS = (0, 17)


def _fastloop_world(torch):
    """The fault study's world (its budget and ISLs) under churn40's fault
    trace, one `Federation` on the card."""
    from repro_torch.fl.api import Federation
    churn40 = dict(fault_scenarios())["churn40"]
    return Federation.from_experiment(fault_study_experiment()).with_faults(
        churn40)


def _random_state(torch, g, K, eng):
    """Random protocol columns for `eng`'s run (its optional columns),
    drawn on the host from `g`, on the card."""
    from repro_torch.core import staleness as SS

    def col(lo, hi):
        return torch.randint(lo, hi, (K,), generator=g,
                             dtype=torch.int32).cuda()
    return SS.SatState(*(None if x is None else col(*span) for x, span in
                         zip(eng.state, ((-1, 5),) * 3 + ((0, 4),) * 2)))


def _host_ms(torch, fn, iters=5):
    """Median host-clock ms of `fn()` ending in a synchronise."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def run_fastloop_path(torch):
    """Phase 5, the fast loop on the card (`fastloop` lines): (a) one CUDA
    graph replay (`ChunkGraphs`) against the eager `_scan_windows` on the
    card, its yardstick, at the buckets of `FASTLOOP_BUCKETS`,
    ground-only, sink and gossip, on the fault study's world (budget,
    ISLs) under churn40's trace, from random protocol states: every state
    column and the counters bit for bit, the graphs captured once a key,
    and each bucket's replay and eager call timed; (b) a stop requested
    mid-chunk at `FASTLOOP_STOPS` under fedbuff and intra_plane, held
    against a run of `max_windows` = stop + 1: windows, protocol columns,
    global version and params bit for bit."""
    from repro_torch.fl import engine as E
    from repro_torch.fl.callbacks import Callback
    from repro_torch.tree import tree_leaves, tree_map
    fed = _fastloop_world(torch)
    g = torch.Generator().manual_seed(0)
    times = {}
    for kind, params, mode in FASTLOOP_MODES:
        eng = fed.with_scheduler(kind, **params).engine()
        eng.prepare()
        if eng._isl_mode != mode:
            raise AssertionError(f"fastloop: {kind} runs mode "
                                 f"{eng._isl_mode}, not {mode}")
        fn, args, _ = eng.scheduler.device_plan(
            0, K=eng.K, state=eng.state, ig=0, connectivity=eng._plan_C,
            status=0.0, link=eng._plan_link)
        args = tree_map(lambda x: torch.as_tensor(x).cuda(), args)
        graphs = E.ChunkGraphs("cuda")
        before = dict(E.graph_counts)
        for h in FASTLOOP_BUCKETS:
            for rep in range(2):
                i0 = int(torch.randint(0, eng.num_windows, (), generator=g))
                nv = int(torch.randint(1, h + 1, (), generator=g))
                ig = int(torch.randint(0, 6, (), generator=g))
                st = _random_state(torch, g, eng.K, eng)
                isl = {"sink": eng._sink_plan(i0) if mode == "sink" else None,
                       "gossip": eng._gossip_dev + (eng._gossip_period,)
                       if mode == "gossip" else None, None: None}[mode]
                i32 = (lambda x: torch.tensor(x, dtype=torch.int32,
                                              device="cuda"))
                kw = dict(indicator=fn, horizon=h, isl_mode=mode)
                ops = (eng._C_dev, i32(i0), i32(nv), args, eng._link_dev,
                       isl, eng._faults_dev)

                def eager():
                    return E._scan_windows(st, i32(ig), *ops, **kw)

                def replay():
                    return graphs(st, ig, eng._C_dev, i0, nv, args,
                                  eng._link_dev, isl, eng._faults_dev, **kw)
                (s1, c1), (s0, c0) = replay(), eager()
                if not torch.equal(c1, c0) or not all(
                        (x is None and y is None) or torch.equal(x, y)
                        for x, y in zip(s1, s0)):
                    raise AssertionError(f"fastloop (a) {kind} bucket {h}: "
                                         f"the graph replay differs from "
                                         f"the eager scan")
            times[f"{mode or 'ground'} {h}"] = {
                "replay_ms": _host_ms(torch, replay),
                "eager_ms": _host_ms(torch, eager)}
        captured = E.graph_counts["captures"] - before["captures"]
        if captured != len(FASTLOOP_BUCKETS):
            raise AssertionError(f"fastloop (a) {kind}: {captured} graphs "
                                 f"captured for {len(FASTLOOP_BUCKETS)} "
                                 f"buckets")
        print(f"fastloop (a) {kind} ({mode or 'ground-only'}), K "
              f"{eng.K}, budget and churn40: buckets "
              f"{list(FASTLOOP_BUCKETS)} replay = eager on the card, bit "
              f"for bit, twice a bucket; {captured} graphs captured",
              flush=True)
    print("fastloop (a) ms a scan, host clock with a synchronise (median "
          "of 5), graph replay and eager:", json.dumps(times), flush=True)

    class StopAt(Callback):
        def __init__(self, window):
            self.window = window

        def on_window_end(self, engine, i):
            if i == self.window:
                engine.request_stop()
    for kind, params, mode in FASTLOOP_MODES[:2]:
        world = fed.with_scheduler(kind, **params)
        for stop in FASTLOOP_STOPS:
            ref = _engine(world, eval_every=1000, max_windows=stop + 1)
            ref.run()
            eng = _engine(world, callbacks=[StopAt(stop)], eval_every=1000)
            res = eng.run()
            if res.windows_run != stop + 1 or eng.ig != ref.ig or \
                    _columns(eng) != _columns(ref) or not all(
                        torch.equal(a, b) for a, b in zip(
                            tree_leaves(eng.params),
                            tree_leaves(ref.params))):
                raise AssertionError(f"fastloop (b) {kind}: the stop at "
                                     f"window {stop} does not freeze the "
                                     f"run one window later")
            print(f"fastloop (b) {kind}: stop at window {stop}: "
                  f"{res.windows_run} windows, ig {eng.ig}, columns and "
                  f"params those of max_windows {stop + 1}; loop "
                  f"{json.dumps(eng.loop_counts)}", flush=True)


# The satellite-axis mesh: benchmarks/hotpaths.py's mesh gate
# (starlink1000 scale: K 1,000, 96 windows, C = default_rng(0).random((96,
# 1000)) < 0.08, FedBuff M 12, a stub adapter), FedSpace's re-plan at the
# paper's shape and the replan service at its serving shape
MESH_GATE = {"K": 1000, "W": 96, "M": 12}
MESH_SEARCH = {"K": 191, "R": 5000, "I0": 24}
MESH_SERVE = {"K": 1000, "R": 20_000, "I0": 24}


class _NullAdapter:
    """A two-parameter model whose loss has zero gradient, on the card:
    client training changes nothing, so a run isolates the protocol (the
    mesh gate's stub adapter). Each aggregation still launches the
    aggregation kernel."""

    def __init__(self, torch, K):
        self.torch, self.clients = torch, list(range(K))
        self.device = torch.device("cuda")

    def init(self, gen):
        return {"w": self.torch.zeros(2, device=self.device)}

    def loss(self, params, batch):
        return (params["w"] * 0.0).sum(-1) + batch[0].sum(-1) * 0.0

    def client_batch(self, ci, round_rng, batch_size, num_batches):
        return (self.torch.zeros((num_batches, 1), device=self.device),)

    def accuracy(self, params):
        return 0.0

    def val_loss(self, params):
        return 0.0


def run_mesh_path(torch, smi):
    """The last phase, after the launch tools': the satellite-axis mesh
    (`mesh` lines) on the world-1 NCCL group that `main` started before
    the train phase and ends after this one
    (`repro_torch.core.mesh.sim_mesh` takes it): (a) the mesh gate's
    run, fast loop (its scans CUDA graphs
    holding their collectives) and host loop, each with the mesh and
    with `mesh=None`: the version, pending and buffered columns, `ig`,
    the staleness histogram and the idle and total connections bit for
    bit, walls, graph captures and replays and `collective_counts`
    printed; (b) `score_candidates(mesh=)` at the paper's re-plan shape
    (K 191, R 5,000, I0 24, a 40-tree forest from a seed) equal to
    `mesh=None` bit for bit, each timed; (c) `ReplanService(mesh=)` at
    K 1,000, R 20,000: two requests, each a sharded full rescan (reason
    "mesh", no cache) equal to the unsharded service's full answer,
    each timed. Then the zoo's mesh on the same group
    (`run_zoo_mesh_path`). Returns the launch counts of (a)'s runs and of
    the zoo mesh's steps."""
    import numpy as np
    from repro_torch.core import mesh as MM
    from repro_torch.core import staleness as SS
    from repro_torch.core.scheduler import make_scheduler
    from repro_torch.core.search import random_candidates, score_candidates
    from repro_torch.fl.engine import EngineConfig, SimulationEngine
    from repro_torch.fl.replan import ReplanService
    from repro_torch.kernels import launch_counts
    card = smi.splitlines()[0]
    t_phase = time.perf_counter()
    mesh = MM.sim_mesh()
    K, W, M = MESH_GATE["K"], MESH_GATE["W"], MESH_GATE["M"]
    C = np.random.default_rng(0).random((W, K)) < 0.08
    out, counts = {}, {}
    launch_counts.clear()
    for fast in (True, False):
        for label, m in (("none", None), ("mesh", mesh)):
            MM.collective_counts.clear()
            eng = SimulationEngine(
                C, _NullAdapter(torch, K),
                make_scheduler("fedbuff", M=M),
                EngineConfig(eval_every=W, max_windows=W,
                             fast_loop=fast), mesh=m)
            with LoopStats(torch) as st:
                res = eng.run()
            key = ("fast" if fast else "host", label)
            out[key] = (eng, res)
            line = dict(st.line(eng),
                        collectives=dict(+MM.collective_counts))
            print(f"mesh (a) K {K}, {W} windows, fedbuff M {M}, "
                  f"{'fast' if fast else 'host'} loop, "
                  f"{'world-1 NCCL mesh' if m else 'mesh=None'}: "
                  f"{json.dumps(line)}; {card}", flush=True)
            if fast and m is not None and not (
                    MM.collective_counts["psum"]
                    and MM.collective_counts["all_gather"]
                    and st.replays):
                raise AssertionError("mesh (a): the mesh's fast loop "
                                     "ran no collective or no graph")
    counts = dict(launch_counts)
    for loop in ("fast", "host"):
        (e0, r0), (e1, r1) = out[loop, "none"], out[loop, "mesh"]
        if not (np.array_equal(e0.version, e1.version)
                and np.array_equal(e0.pending, e1.pending)
                and np.array_equal(e0.buffered_base, e1.buffered_base)
                and e0.ig == e1.ig
                and r0.staleness_hist.tolist()
                == r1.staleness_hist.tolist()
                and r0.idle_connections == r1.idle_connections
                and r0.total_connections == r1.total_connections):
            raise AssertionError(f"mesh (a) {loop} loop: the mesh run "
                                 f"differs from mesh=None")
    (e0, r0) = out["fast", "none"]
    if r0.num_global_updates == 0 or counts.get(
            "weighted_aggregate") != 4 * r0.num_global_updates:
        raise AssertionError(f"mesh (a): {counts} launches for 4 runs "
                             f"of {r0.num_global_updates} aggregations")
    print(f"mesh (a): fast and host loop, mesh = mesh=None bit for bit "
          f"(columns, ig {e0.ig}, histogram, idle "
          f"{r0.idle_connections} of {r0.total_connections} "
          f"connections, {r0.num_global_updates} aggregations); "
          f"{card}", flush=True)

    rf = _search_forest()
    for tag, shape in (("(b) score_candidates", MESH_SEARCH),
                       ("(c) ReplanService", MESH_SERVE)):
        K, R, I0 = shape["K"], shape["R"], shape["I0"]
        r = np.random.default_rng(1)
        C = r.random((I0 + 1, K)) < 0.15
        ig = 20
        state = SS.SatState(*(torch.as_tensor(
            r.integers(-1, ig + 1, K).astype(np.int32), device="cuda")
            for _ in range(3)))
        if tag.startswith("(b)"):
            cands = random_candidates(r, I0, 4, 8, R)
            calls = {label: (lambda m=m: score_candidates(
                cands, C[:I0], state, ig, rf, 1.0, mesh=m))
                for label, m in (("none", None), ("mesh", mesh))}
            got = {k: f() for k, f in calls.items()}
            if not np.array_equal(got["mesh"], got["none"]):
                raise AssertionError("mesh (b): sharded scores differ")
            ms = {k: _time_ms(f, 5) for k, f in calls.items()}
            row = {"K": K, "R": R, "I0": I0, "scores_equal": True,
                   "ms_none": ms["none"], "ms_mesh": ms["mesh"]}
        else:
            svc = ReplanService(rf, I0=I0, num_candidates=R, n_min=4,
                                n_max=8, mesh=mesh)
            ms = {"mesh": [], "none": []}
            for i in range(2):
                draws = {}
                for label, s in (("mesh", svc), ("none", ReplanService(
                        rf, I0=I0, num_candidates=R, n_min=4,
                        n_max=8))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    draws[label] = s.replan(
                        i, C[i:i + I0], state, ig, 1.0,
                        rng=np.random.default_rng(10 + i))
                    ms[label].append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(draws["mesh"], draws["none"]):
                    raise AssertionError(f"mesh (c) request {i}: the "
                                         f"sharded answer differs")
                if (svc.last_mode, svc.last_reason) != ("full", "mesh") \
                        or svc.pool is not None:
                    raise AssertionError("mesh (c): the service under a "
                                         "mesh cached or took no full "
                                         "rescan")
            row = {"K": K, "R": R, "I0": I0, "answers_equal": True,
                   "reason": svc.last_reason, "stats": svc.stats,
                   "ms_mesh": ms["mesh"], "ms_none": ms["none"]}
        print(f"mesh {tag}: {json.dumps(row)}; {card}", flush=True)
    print(f"mesh: phase {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    # the zoo's mesh, carved out of the same group before it ends
    zoo_counts = run_zoo_mesh_path(torch, card)
    return {"mesh": counts, "zoo_mesh": zoo_counts}


# The zoo mesh phase (`zoo mesh` lines): the zoo's launch layer on a mesh
# carved out of the mesh phase's world-1 NCCL group. (b) qwen3-8b as train
# (b); (c) qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B: d_model 2048, 128
# experts, top 8, d_ff 768) cut to 4 of its 48 layers, for memory: its
# 3.1 B parameters need ~43 GB of bf16 params, float32 gradient sums and
# AdamW moments, and the three gradient trees compared beside each other
# ~43 GB with the params; (d) whisper-base's agg_m96 as launch (b).
ZOO_MESH_MOE_LAYERS = 4
ZOO_MESH_TRAIN = (2, 2048)           # batch, sequence: 2 microbatches
ZOO_MESH_STEPS = 2
ZOO_MESH_AGG = ("whisper-base", 96)
ZOO_MESH_AGG_ITERS = 5


def _zoo_mesh_train(torch, cfg, mesh, moe_groups, batches):
    """ZOO_MESH_STEPS steps of `build`'s train step on `mesh` (None: one
    device) from seed 0's params: (per step ms, per step collectives,
    loss, the state's digests, peak bytes)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import mesh as MM
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    B, S = ZOO_MESH_TRAIN
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    fn, _, _, _ = ST.build(cfg, shape, mesh, moe_groups=moe_groups)
    params = T.init_params(0, cfg, device="cuda")
    opt = ST.init_opt_state(params, cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, coll, losses = [], [], []
    for b in batches:
        MM.collective_counts.clear()
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(dict(MM.collective_counts))
        losses.append(m["loss"].item())
    digests = [_digest(torch, t) for t in tree_leaves([params, opt])]
    peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    return ms, coll, losses, digests, peak


def run_zoo_mesh_path(torch, card):
    """The zoo's mesh (`launch/mesh.py`, `sharding.py`, the steps of
    `launch/steps.py` on a mesh, `moe.moe_apply_ep`) on the mesh phase's
    world-1 NCCL group, before it ends: (a) `make_production_mesh()`
    refused on one card, its message printed, and `make_host_mesh()` a
    (1, 1) mesh; (b) qwen3-8b cut to 8 layers (train (b)'s configuration)
    two steps through `build` on the host mesh (data parallel with ZeRO-1,
    every collective issued) and two with `mesh=None` from the same init
    and batches: params and moments equal bit for bit; (c) qwen3-moe at
    full width cut to `ZOO_MESH_MOE_LAYERS` layers: the expert-parallel
    loss and gradients (`moe_groups=-2` on the host mesh) against the
    grouped step's (`moe_groups=1`, `mesh=None`) and against the plain
    versions' within `_train_full`'s tolerances, then one train step of
    each timed; (d) `make_agg_step_opt` at whisper-base's agg_m96 on the
    host mesh = `mesh=None` bit for bit, each timed. Returns the launch
    counts of (b)'s and (c)'s steps."""
    from collections import Counter
    from repro_torch.configs.base import ShapeConfig, StageSpec, get_config
    from repro_torch.core import mesh as MM
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.agg.ops import flat_tree
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    counts = Counter()
    torch.cuda.empty_cache()

    # (a) the production mesh needs 256 ranks; the host mesh is (1, 1)
    try:
        make_production_mesh()
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("zoo mesh (a): a production mesh on one card")
    host = make_host_mesh()
    if MM.axis_sizes(host) != {"data": 1, "model": 1}:
        raise AssertionError(f"zoo mesh (a): host mesh {host}")
    print(f"zoo mesh (a): make_production_mesh() refused: {refused}; "
          f"make_host_mesh() = {MM.axis_sizes(host)}; {card}", flush=True)

    # (b) qwen3-8b, host mesh against mesh=None, bit for bit
    L = QWEN_TRAIN_LAYERS
    cfg, full = train_cut("qwen3-8b", L, (StageSpec(("global",), L),))
    B, S = ZOO_MESH_TRAIN
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    batches = [synthetic_lm_batch(cfg, shape, s)
               for s in range(ZOO_MESH_STEPS)]
    runs = {}
    for label, mesh in (("none", None), ("host", host)):
        launch_counts.clear()
        runs[label] = _zoo_mesh_train(torch, cfg, mesh, 1, batches)
        runs[label] += (dict(launch_counts),)
        counts.update(launch_counts)
    (ms0, c0, l0, d0, p0, k0), (ms1, c1, l1, d1, p1, k1) = (
        runs["none"], runs["host"])
    same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(d0, d1))
    if not same or k0 != k1 or not all(c.get("all_reduce") for c in c1):
        raise AssertionError(f"zoo mesh (b): host mesh = mesh=None "
                             f"{same}, launches {k1} / {k0}, collectives "
                             f"{c1}")
    print("zoo mesh (b)", json.dumps({
        "arch": cfg.name, "layers": f"{L} of {full.num_layers}",
        "batch": B, "seq": S, "dtype": cfg.param_dtype,
        "steps": ZOO_MESH_STEPS, "bit_for_bit": same, "loss": l1,
        "ms_per_step_host_mesh": ms1, "ms_per_step_none": ms0,
        "collectives_per_step": c1,
        "peak_gb_host_mesh": p1 / 1e9, "peak_gb_none": p0 / 1e9,
        "launches_per_run": k1}) + f"; {card}", flush=True)
    del batches
    torch.cuda.empty_cache()

    # (c) qwen3-moe: expert parallelism against the grouped path
    Lm = ZOO_MESH_MOE_LAYERS
    cfg, full = train_cut("qwen3-moe-30b-a3b", Lm,
                          (StageSpec(("global",), Lm),))
    batches = [synthetic_lm_batch(cfg, shape, s) for s in range(2)]
    params = T.init_params(0, cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    steps = {label: ST.build(cfg, shape, mesh, moe_groups=g)[0]
             for label, mesh, g in (("ep", host, -2), ("grouped", None, 1))}
    MM.collective_counts.clear()
    launch_counts.clear()
    loss_ep, g_ep = steps["ep"].loss_and_grad(params, batches[0])
    ep_sums = dict(MM.collective_counts)
    counts.update(launch_counts)
    launch_counts.clear()
    loss_gr, g_gr = steps["grouped"].loss_and_grad(params, batches[0])
    counts.update(launch_counts)
    with PlainVersions():
        loss_pl, g_pl = steps["ep"].loss_and_grad(params, batches[0])
    g_ep, g_gr, g_pl = (tree_leaves(g) for g in (g_ep, g_gr, g_pl))
    loss_tol, grad_tol = Lm * 2 ** -8, 2 * Lm * 2 ** -8
    vs_plain = [_rel_l2(a, b) for a, b in zip(g_ep, g_pl)]
    err = {"loss_vs_grouped": abs(loss_ep.item() - loss_gr.item())
           / abs(loss_gr.item()),
           "grad_vs_grouped": max(_rel_l2(a, b) for a, b in zip(g_ep, g_gr)),
           "loss_vs_plain": abs(loss_ep.item() - loss_pl.item())
           / abs(loss_pl.item()),
           "grad_vs_plain": max(vs_plain), "grad_vs_plain_by_leaf": vs_plain,
           "grads_bit_equal_grouped": all(torch.equal(a, b)
                                          for a, b in zip(g_ep, g_gr))}
    del g_ep, g_gr, g_pl, params
    torch.cuda.empty_cache()
    if max(err["loss_vs_grouped"], err["loss_vs_plain"]) > loss_tol or max(
            err["grad_vs_grouped"], err["grad_vs_plain"]) > grad_tol or not (
            ep_sums.get("psum_partial") and ep_sums.get("grad_psum_grad")):
        raise AssertionError(f"zoo mesh (c): {err}, EP sums {ep_sums}")
    timed = {}
    for label, mesh, g in (("ep", host, -2), ("grouped", None, 1)):
        launch_counts.clear()
        ms, coll, losses, _, peak = _zoo_mesh_train(torch, cfg, mesh, g,
                                                    batches[:1])
        counts.update(launch_counts)
        timed[label] = {"ms_per_step": ms[0], "collectives_per_step": coll[0],
                        "loss": losses[0], "peak_gb": peak / 1e9,
                        "launches": dict(launch_counts)}
    print("zoo mesh (c)", json.dumps({
        "arch": cfg.name, "layers": f"{Lm} of {full.num_layers}",
        "params": n_params, "experts": cfg.num_experts,
        "top_k": cfg.experts_per_token, "batch": B, "seq": S,
        "dtype": cfg.param_dtype, "errors": err,
        "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol},
        "ep_sums_per_loss_and_grad": ep_sums, **timed}) + f"; {card}",
        flush=True)
    del batches
    torch.cuda.empty_cache()

    # (d) the sharded agg step on the host mesh = mesh=None
    arch, m = ZOO_MESH_AGG
    cfg = get_config(arch)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = flat_tree(T.init_params(0, cfg, device="meta"), device="cuda")
    upd = flat_tree(params, lead=(m,))
    for t in tree_leaves(params):
        t.normal_(0, 0.02, generator=g)
    for t in tree_leaves(upd):
        t.normal_(0, 0.01, generator=g)
    stal = torch.randint(0, 9, (m,), generator=g, device="cuda",
                         dtype=torch.int32)
    calls = {label: (lambda f=ST.make_agg_step_opt(cfg, mesh): f(
        params, upd, stal)) for label, mesh in (("none", None),
                                                ("host", host))}
    MM.collective_counts.clear()
    got = {k: f() for k, f in calls.items()}
    reduces = MM.collective_counts["all_reduce"]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got["host"]), tree_leaves(got["none"])))
    if not same or reduces != len(tree_leaves(params)):
        raise AssertionError(f"zoo mesh (d): host mesh = mesh=None {same}, "
                             f"{reduces} all-reduces")
    del got
    ms = {k: _time_ms(f, ZOO_MESH_AGG_ITERS) for k, f in calls.items()}
    print("zoo mesh (d)", json.dumps({
        "arch": arch, "m": m, "params": sum(t.numel() for t in
                                            tree_leaves(params)),
        "dtype": cfg.param_dtype, "bit_for_bit": same,
        "all_reduces": reduces, "ms_host_mesh": ms["host"],
        "ms_none": ms["none"]}) + f"; {card}", flush=True)
    del params, upd, calls
    torch.cuda.empty_cache()
    print(f"zoo mesh: phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {dict(counts)}; {card}", flush=True)
    return dict(counts)


def transformer_experiment():
    """The quickstart's FedBuff world with the transformer payload at the
    adapter's own width (d_model 32, 2 layers, 4 heads over 2 kv heads,
    swiglu d_ff 64, the 32 features read as 8 tokens of width 4), no
    target accuracy, so the run length cannot depend on floats."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="quickstart-transformer",
        constellation=ConstellationConfig(num_satellites=40, days=3.0),
        dataset=DatasetConfig(num_train=4000, num_val=1000, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="transformer", params={}),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 20}),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=12,
                           max_windows=288, stop_at_target=False))


# The path's card and CPU runs cover the first TRANSFORMER_WINDOWS of the
# experiment's 288 windows (the whole horizon's CPU run took 69-78 s).
TRANSFORMER_WINDOWS = 96
# The reference's counters for `transformer_experiment` over its first
# TRANSFORMER_WINDOWS windows (FedBuff decides on buffer counts alone, so
# they are the MLP world's): a CPU run of the JAX package's Federation on
# the same experiment with `max_windows` 96 (over all 288 windows: 36,
# 755, 89, 1300).
TRANSFORMER_REFERENCE = {"num_global_updates": 11,
                         "num_aggregated_gradients": 228,
                         "idle_connections": 33, "total_connections": 421,
                         "windows_run": TRANSFORMER_WINDOWS}
# Tolerances of the card against the CPU on the transformer path, float32.
# One SGD step is the gradient itself: the same sums in other orders.
STEP_TOL = 1e-4
# Sixteen steps at lr 1.0 carry a rounding difference forward and grow it:
# `check_client_update` prints, beside the card's difference, how far the
# CPU's own 16-step update moves when its parameters move by 1e-7 of their
# value (one rounding), a few 1e-3 on leaves of magnitude 0.3 to 0.9.
UPDATE_TOL = 2e-2
# The first evaluation (window 11) follows one aggregation of such
# updates, averaged over the satellites; relative to the loss.
FIRST_LOSS_TOL = 1e-3


def run_transformer_path(torch):
    """Phase 5, the transformer path, over the experiment's first
    TRANSFORMER_WINDOWS windows on the card and on the CPU. Returns the
    launch counts of the card's run."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    exp = transformer_experiment()
    launch_counts.clear()
    t0 = time.perf_counter()
    fed = Federation.from_experiment(exp)
    res = _first_windows(fed, TRANSFORMER_WINDOWS).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print("transformer path (cuda):", json.dumps(res.summary()), flush=True)
    print(f"transformer path (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts}", flush=True)
    _one_launch_per_aggregation(res, counts)
    # every forward makes 5 RMSNorm and 2 attention calls, every backward
    # the same number of backward calls
    fa, fb = counts.get("flash_attention", 0), counts.get(
        "flash_attention_bwd", 0)
    if fb == 0 or 2 * counts.get("rmsnorm", 0) != 5 * fa \
            or 2 * counts.get("rmsnorm_bwd", 0) != 5 * fb:
        raise AssertionError(f"expected rmsnorm = 5/2 flash_attention, "
                             f"forward and backward, with backward calls; "
                             f"got {counts}")
    # the path's attention is float32 at hd 8: the CUDA cores' route, both
    # directions
    if counts.get("flash_attention_tc", 0) or counts.get(
            "flash_attention_bwd_tc", 0):
        raise AssertionError(f"float32 attention took the tensor cores: "
                             f"{counts}")
    # ... and, at S = 8, the short-sequence kernels: every call, both ways
    if counts.get("flash_attention_short", 0) != fa or counts.get(
            "flash_attention_bwd_short", 0) != fb:
        raise AssertionError(f"attention calls that did not take the "
                             f"short-sequence kernels: {counts}")
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    for name, want in TRANSFORMER_REFERENCE.items():
        if getattr(res, name) != want:
            raise AssertionError(f"{name}: card {getattr(res, name)}, "
                                 f"reference {want}")

    t0 = time.perf_counter()
    cpu_fed = Federation.from_experiment(exp, device="cpu")
    cpu = _first_windows(cpu_fed, TRANSFORMER_WINDOWS).run()
    print("transformer path (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    first = abs(res.val_loss[0] - cpu.val_loss[0])
    print(f"first val_loss: card {res.val_loss[0]} CPU {cpu.val_loss[0]} "
          f"(|diff| {first}, relative tolerance {FIRST_LOSS_TOL})",
          flush=True)
    if first > FIRST_LOSS_TOL * abs(cpu.val_loss[0]):
        raise AssertionError("first val_loss differs beyond tolerance")
    # 176 SGD steps at lr 1.0 carry the float32 rounding differences of
    # the kernels' and cuBLAS's summation orders forward; an accuracy on
    # 1000 validation samples may move by a few argmax flips
    _close_accuracy(res, cpu, 0.02)
    check_client_update(torch, fed.adapter, cpu_fed.adapter, exp.train)
    step = trace_client_update(torch, fed.adapter, exp.train)
    print("client step", json.dumps(step), flush=True)
    return counts


def trace_aggregations_apart():
    """`trace_aggregation` on both paths in a fresh process
    (`scripts/trace_aggregation.py`): in this one, after the profiler
    windows above, the profiler records few device events or none. Prints
    one `aggregation trace` line a path; fails if the script fails, if an
    aggregation ran more than one aggregation kernel, or if a cat or a
    gather ran (a dropped event can only lower these counts)."""
    out = subprocess.run([sys.executable,
                          str(ROOT / "scripts" / "trace_aggregation.py"),
                          "--label", "chip_smoke"], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"scripts/trace_aggregation.py failed:\n"
                             f"{out.stderr[-3000:]}")
    traced = json.loads(out.stdout.strip().splitlines()[-1])
    for exp in (quickstart_experiment(), transformer_experiment()):
        t = traced[exp.name]
        print("aggregation trace", json.dumps(t), flush=True)
        if t["agg_kernels"] > 1 or t["cat_gather_kernels"]:
            raise AssertionError(f"an aggregation of {exp.name} ran "
                                 f"{t['agg_kernels']} aggregation kernels "
                                 f"and {t['cat_gather_kernels']} cats or "
                                 f"gathers")


def _is_copy(name):
    return "copy" in name.lower()


def _is_copy_kernel(name):
    """A kernel that moves data (a copy, a `torch.cat`, a gather or
    indexing), not a host-device transfer."""
    low = name.lower()
    return "memcpy" not in low and any(
        w in low for w in ("copy", "gather", "index"))


def trace_aggregation(torch, exp, traced=3):
    """The federation of `exp` on the card, stopped once `traced`
    aggregations were traced and as many timed. For each aggregation the
    window from the end of its last batched client update
    (`SimulationEngine._run_batched`) to the new params (the engine's next
    call, `SS.aggregate_step`): the host microseconds of the untraced ones
    after the first (host clock ending in a synchronise), and, traced with
    `torch.profiler` (every other one), its device kernels by name, the
    aggregation kernels, the copy kernels (copies, dtype casts, cats,
    gathers), the cat and gather kernels among them, the host-to-device
    transfers and the device microseconds. The profiler on the H100
    machines drops kernel events, most after other profiler windows in
    the same process, and now and then records none: a window without a
    device event is traced again, and the counts are a floor. It hooks
    only `_run_batched` and the engine module's `SS`, so it runs on any
    checkout of the port (`scripts/trace_aggregation.py`)."""
    from repro_torch.fl import engine as E
    from repro_torch.fl.api import Federation
    eng = Federation.from_experiment(exp).engine()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    st = {"prof": None, "t0": None, "n": 0}
    host_us, traces = [], []
    run_batched = eng._run_batched

    def hooked_run(*args, **kw):
        if st["prof"] is not None:      # not the aggregation's last group
            st["prof"].stop()
            st["prof"] = None
        out = run_batched(*args, **kw)
        torch.cuda.synchronize()
        if st["n"] % 2:
            st["prof"] = torch.profiler.profile(activities=acts)
            st["prof"].start()
        st["t0"] = time.perf_counter()
        return out

    real = E.SS

    class _Hooked:
        def __getattr__(self, name):
            return getattr(real, name)

        def aggregate_step(self, *args, **kw):
            torch.cuda.synchronize()
            us = (time.perf_counter() - st["t0"]) * 1e6
            if st["prof"] is not None:
                st["prof"].stop()
                events = _device_events(st["prof"])
                if events:
                    traces.append(events)
                st["prof"] = None
            elif st["n"]:
                host_us.append(us)
            st["n"] += 1
            if len(traces) >= traced and len(host_us) >= traced \
                    or st["n"] > 6 * traced:
                eng.request_stop()
            return real.aggregate_step(*args, **kw)

    eng._run_batched = hooked_run
    E.SS = _Hooked()
    try:
        eng.run()
    finally:
        E.SS = real
    if len(traces) < traced:
        raise AssertionError(f"{len(traces)} of the traced aggregations "
                             f"showed device events, not {traced}")
    per = 1 / len(traces)
    by_name = {}
    for events in traces:
        for n, c, _ in events:
            by_name[n[:120]] = by_name.get(n[:120], 0) + c * per
    return {"experiment": exp.name, "aggregations_traced": len(traces),
            "host_us": host_us,
            "kernels": sum(c for ev in traces for _, c, _ in ev) * per,
            "agg_kernels": sum(c for ev in traces for n, c, _ in ev
                               if "agg_" in n) * per,
            "copy_kernels": sum(c for ev in traces for n, c, _ in ev
                                if _is_copy_kernel(n)) * per,
            "cat_gather_kernels": sum(
                c for ev in traces for n, c, _ in ev
                if any(w in n.lower() for w in ("catarray", "gather",
                                                "index"))) * per,
            "host_to_device": sum(c for ev in traces for n, c, _ in ev
                                  if "memcpy" in n.lower()) * per,
            "device_us": [sum(t for _, _, t in ev) for ev in traces],
            "by_name": by_name}


def _trainable_mask(adapter, params):
    """The adapter's frozen-parameter mask, as the engine builds it."""
    return adapter.trainable_mask(params) \
        if hasattr(adapter, "trainable_mask") else None


def trace_client_update(torch, adapter, train, runs=5, m=MAIN_PATH_M):
    """One batched client update of a path (the first `m` satellites,
    `local_steps` SGD steps at the path's lr, with the adapter's mask),
    traced with `torch.profiler` after a warm-up: kernels, copy kernels
    and device microseconds per SGD step (the slowest kernels' by name),
    and the wall of a step from `runs` untraced updates (host clock,
    ending in a synchronise), with the busy share (device time over
    wall). The profiler drops a few kernel events on the H100 machines,
    so the kernel counts are a floor."""
    from repro_torch.fl.client import make_batched_client_update
    params = adapter.init(torch.Generator().manual_seed(0))
    batch, rows = adapter.client_batch_many(list(range(m)), 0,
                                            train.batch_size,
                                            train.local_steps)
    update = make_batched_client_update(
        adapter, local_steps=train.local_steps, lr=train.client_lr,
        trainable_mask=_trainable_mask(adapter, params))
    batch = tuple(batch)
    update(params, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        update(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / train.local_steps * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        update(params, batch)
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("torch.profiler shows no device time")
    steps = train.local_steps
    dev_us = sum(t for _, _, t in events) / steps
    wall_ms = sorted(walls)[len(walls) // 2]
    return {"satellites": len(rows), "sgd_steps": steps,
            "kernels_per_step": sum(c for _, c, _ in events) / steps,
            "copy_kernels_per_step": sum(c for n, c, _ in events
                                         if _is_copy(n)) / steps,
            "device_us_per_step": dev_us, "wall_ms_per_step": walls,
            "busy_share": dev_us / (wall_ms * 1e3),
            "kernels_by_name": {n[:120]: c for n, c, _ in sorted(
                events, key=lambda e: -e[1])},
            "device_us_per_step_by_name": {n[:120]: t / steps for n, _, t in
                                           sorted(events,
                                                  key=lambda e: -e[2])[:8]}}


def trace_attention_call(torch, iters=200):
    """The transformer path's attention call as its adapter makes it, one
    forward and one backward of `ops.flash_attention_bshd` on (B, S, H, hd)
    projections, o read as (B, S, H * hd) and the cotangent given so: the
    host microseconds of a forward (recording the graph), of a forward
    and backward, and of the (B, H, S, hd) wrappers' forward and backward
    calls on the same values (host clock over `iters` calls, no
    synchronising inside), then, traced, the device kernels the path's
    call runs, by name, per call."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    B, H, KH, S, _, hd = FLASH_PATH[:6]
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(B, S, 32, generator=g, device="cuda")
    w = [torch.randn(32, n * hd, generator=g, device="cuda")
         for n in (H, KH, KH)]
    do = torch.randn(B, S, H * hd, generator=g, device="cuda")
    # the projections are made outside the traced window
    inputs = [(x @ wi).reshape(B, S, -1, hd) for wi in w]

    def call():
        q, k, v = (t.detach().requires_grad_() for t in inputs)
        o = flash_attention_bshd(q, k, v, causal=True).reshape(B, S, H * hd)
        return torch.autograd.grad(o, (q, k, v), do)

    def forward():
        q, k, v = (t.detach().requires_grad_() for t in inputs)
        return flash_attention_bshd(q, k, v, causal=True)
    bhsd = [t.transpose(1, 2).contiguous() for t in inputs]
    o, lse = K.flash_attention(*bhsd)
    do_bhsd = do.view(B, S, H, hd).transpose(1, 2).contiguous()
    host_us = {}
    for name, fn in (
            ("forward", forward), ("forward and backward", call),
            ("wrapper forward (B, H, S, hd)", lambda: K.flash_attention(
                *bhsd)),
            ("wrapper backward (B, H, S, hd)", lambda: K.flash_attention_bwd(
                *bhsd, o, lse, do_bhsd))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = 20
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(traced):
            call()
        torch.cuda.synchronize()
    events = _device_events(prof)
    return {"host_us": host_us, "calls": traced,
            "kernels_per_call": {n[:120]: c / traced for n, c, _ in events},
            "copy_kernels_per_call": sum(c for n, c, _ in events
                                         if _is_copy(n)) / traced}


def check_client_update(torch, card, cpu, train, m=MAIN_PATH_M,
                        tols=(STEP_TOL, UPDATE_TOL)):
    """A path adapter's batched client update (the first `m` satellites,
    at the path's lr, with the adapter's mask) on the card and on the
    CPU, from the same parameters and batches, compared leaf by leaf
    within `tols` (one step, `local_steps` steps): on the transformer path
    the ops' autograd functions (kernels both ways) against autograd of
    the plain versions. The card's update is run twice and must repeat
    bit for bit. It runs after the path's launch counts were read."""
    import numpy as np
    from repro_torch.fl.client import make_batched_client_update
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import params_from_numpy, params_to_numpy
    params = params_to_numpy(cpu.init(torch.Generator().manual_seed(0)))
    mask = _trainable_mask(cpu, params)
    runs = []
    for adapter in (card, cpu):
        batch, rows = adapter.client_batch_many(
            list(range(m)), 0, train.batch_size, train.local_steps)
        runs.append((adapter, rows, batch))
    (_, rows, batch), (_, rows_cpu, batch_cpu) = runs
    if rows != rows_cpu or not all(torch.equal(a.cpu(), b)
                                   for a, b in zip(batch, batch_cpu)):
        raise AssertionError("the card's and the CPU's batches differ")
    for steps, tol in zip((1, train.local_steps), tols):
        def update(adapter, batch, start):
            return params_to_numpy(make_batched_client_update(
                adapter, local_steps=steps, lr=train.client_lr,
                trainable_mask=mask)(
                    params_from_numpy(start, adapter.device),
                    tuple(b[:, :steps] for b in batch)))

        got, want = (update(adapter, batch, params)
                     for adapter, _, batch in runs)
        again = update(card, batch, params)
        if not all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(again))):
            raise AssertionError(f"two card updates of {steps} steps "
                                 f"differ")
        if mask is not None and any(
                m_ == 0.0 and (a.any() or b.any()) for m_, a, b in zip(
                    tree_leaves(mask), tree_leaves(got), tree_leaves(want))):
            raise AssertionError("a frozen leaf moved")
        err = tree_map(lambda a, b: float(abs(a - b).max()), got, want)
        # each device's own spread: its parameters moved by one rounding
        # (the same nudge on both), against its own update unnudged
        r = np.random.default_rng(0)
        nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
            a.shape))).astype(a.dtype), params)
        spread, card_spread = (max(float(abs(a - b).max()) for a, b in zip(
            tree_leaves(update(adapter, b_, nudged)), tree_leaves(ref)))
            for adapter, b_, ref in ((cpu, batch_cpu, want),
                                     (card, batch, got)))
        print(f"client update ({len(rows)} satellites, {steps} steps, "
              f"two card calls bit for bit alike): "
              f"max |card - CPU| per leaf {json.dumps(err)}, tolerance "
              f"rtol {tol}, atol {tol}; the spread under a 1e-7 relative "
              f"nudge: CPU {spread}, card {card_spread}", flush=True)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a.shape != b.shape or not np.allclose(a, b, rtol=tol,
                                                     atol=tol):
                raise AssertionError(f"client update of {steps} steps "
                                     f"differs beyond tolerance")


# The quickstart's FedSpace row (examples/quickstart.py): the schedule
# search's knobs and phase 1's setup.
FEDSPACE_PARAMS = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 500}
# (a)'s histogram-forest run over the world's first 144 of 288 windows
# (6 re-plans), a cut that keeps the script inside its time limit
FEDSPACE_HIST_WINDOWS = 144
FEDSPACE_SETUP = {"pretrain_rounds": 25, "clients_per_round": 16,
                  "utility_samples": 120, "local_steps": 16,
                  "client_lr": 1.0}
T_FEATURE = 12           # the training status T among the 13 features
C13_BAND = 1e-5          # a forest split on T this near a re-plan's T


def fedspace_experiment(params, setup=None):
    """The quickstart world under FedSpace with `params` (and phase-1
    `setup`)."""
    import dataclasses
    from repro_torch.fl.api import SchedulerConfig
    return dataclasses.replace(
        quickstart_experiment(), name="quickstart-fedspace",
        scheduler=SchedulerConfig(kind="fedspace", params=params,
                                  setup=setup or {}))


class Replans:
    """Records every re-plan of the FedSpace schedulers (global version,
    status T, chosen schedule) by wrapping `search.fedspace_search`, which
    the scheduler calls through its module, while the block runs."""

    def __enter__(self):
        from repro_torch.core import search
        self.log, self._inner = [], search.fedspace_search

        def recording(rng, C_window, state, ig, regressor, status, **kw):
            out = self._inner(rng, C_window, state, ig, regressor, status,
                              **kw)
            self.log.append({"ig": int(ig), "status": float(status),
                             "schedule": out.copy()})
            return out
        search.fedspace_search = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.core import search
        search.fedspace_search = self._inner


def _same_schedules(card, cpu, regressor=None, t_split_ok=False):
    """Every re-plan's schedule equal, card against CPU: returns None. On
    the first difference, print both re-plans (their statuses) and the
    forest threshold on T nearest to them, then fail; with `t_split_ok`
    return that re-plan's index instead when the threshold shows the
    cause (ROADMAP C13): it lies within `C13_BAND` of the re-plan's T on
    either device, or between the two."""
    if len(card) == len(cpu) and all(
            (a["schedule"] == b["schedule"]).all()
            for a, b in zip(card, cpu)):
        return None
    j = next((j for j, (a, b) in enumerate(zip(card, cpu))
              if not (a["schedule"] == b["schedule"]).all()),
             min(len(card), len(cpu)))
    print(f"re-plans: card {len(card)}, CPU {len(cpu)}; first difference "
          f"at re-plan {j}", flush=True)
    for side, log in (("card", card), ("CPU", cpu)):
        if j < len(log):
            print(f"  {side}: ig {log[j]['ig']} status {log[j]['status']!r}"
                  f" schedule {log[j]['schedule'].tolist()}", flush=True)
    if regressor is not None and j < min(len(card), len(cpu)):
        fa = regressor.arrays()
        th = fa.thresh[fa.feature == T_FEATURE]
        st = card[j]["status"]
        near = float(th[abs(th - st).argmin()]) if th.size else None
        print(f"  nearest forest threshold on T: {near!r} "
              f"({th.size} splits on T)", flush=True)
        lo, hi = sorted((st, cpu[j]["status"]))
        cause = th[(th >= lo - C13_BAND) & (th <= hi + C13_BAND)]
        if t_split_ok and cause.size:
            print(f"C13: the schedules part at re-plan {j} on the forest's "
                  f"split at T = {float(cause[0])!r}; the card's T "
                  f"{st!r}, the CPU's {cpu[j]['status']!r}", flush=True)
            return j
    raise AssertionError("FedSpace schedules differ, card against CPU")


def _hist_forest(seed=3, s_max=8, n=400):
    """A forest over staleness histograms whose training features all
    carry status 1.0 (tests/test_hotpath_parity.py's fixture, fitted with
    the port's forest): no split is on T, so a schedule cannot depend on
    the float val loss."""
    import numpy as np
    from repro_torch.core.utility import RandomForestRegressor, featurize
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 25, (n, s_max + 1)).astype(np.float32)
    X = featurize(hists, 1.0)
    s = np.arange(s_max + 1, dtype=np.float32)
    y = ((hists * (1.2 - 0.3 * s)).sum(1) / np.maximum(hists.sum(1), 1.0)
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return RandomForestRegressor(n_trees=20, max_depth=6, seed=seed).fit(X, y)


def _fedspace_runs(torch, exp, card_fed, p0, tag, host_pair=False):
    """The run on the card (launch counts read around it), with
    `host_pair` the card's host-loop run held to it (`_strategies`), then
    the same experiment on the CPU from `p0`; counters, schedules and
    final accuracy compared. Returns (card result, launch counts)."""
    import math
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card, LoopStats(torch) as stats:
        eng = card_fed.engine()
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    print(f"fedspace {tag} (cuda):", json.dumps(res.summary()), flush=True)
    d = res.time_to_target_days
    print(f"fedspace {tag} (cuda): wall {wall:.3f} s, days_to_35%="
          f"{d if d else 'not reached'} updates={res.num_global_updates} "
          f"idle={res.idle_connections}/{res.total_connections} "
          f"staleness_hist={res.staleness_hist.tolist()}, re-plans "
          f"{len(card.log)}, launches {counts}", flush=True)
    _one_launch_per_aggregation(res, counts)
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    if host_pair:
        _strategies(torch, f"fedspace {tag}", card_fed, eng, res, stats,
                    fast_replans=card.log)
        print(f"fedspace {tag}: {len(card.log)} re-plans, schedules equal,"
              f" fast loop against host loop on the card", flush=True)
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu = Federation.from_experiment(exp, device="cpu").run(
            init_params=p0)
    print(f"fedspace {tag} (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    _same_schedules(card.log, cpu_log.log, card_fed.scheduler.regressor)
    print(f"fedspace {tag}: {len(card.log)} re-plans, schedules equal, card"
          f" against CPU", flush=True)
    _close_accuracy(res, cpu, 0.01)
    return res, counts


def run_fedspace_path(torch):
    """Phase 6, the FedSpace path. (a) the quickstart world with a
    histogram-only forest, card against CPU; (b) the quickstart's FedSpace
    row as a user runs it: phase 1 on the card (its samples generated
    twice, bit for bit alike), the run on the card, then on the CPU with
    the same regressor; (c) the re-plan's cost. Returns the launch counts
    of (b)'s card run."""
    import dataclasses

    import numpy as np
    from repro_torch.core.utility import RandomForestRegressor
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.fl.fedspace_setup import (phase1_samples,
                                               pretrain_trajectory)
    from repro_torch.weights import params_to_numpy

    # (a)
    exp = fedspace_experiment({**FEDSPACE_PARAMS,
                               "regressor": _hist_forest()})
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, max_windows=FEDSPACE_HIST_WINDOWS))
    fed = Federation.from_experiment(exp)
    p0 = params_to_numpy(fed.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    _fedspace_runs(torch, exp, fed, p0, "histogram forest", host_pair=True)

    # (b) phase 1 as the quickstart builds it: a FedBuff world, then
    # with_scheduler
    base = Federation.from_experiment(quickstart_experiment())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = base.with_scheduler(SchedulerConfig(
        kind="fedspace", params=FEDSPACE_PARAMS, setup=FEDSPACE_SETUP))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"fedspace phase 1 (cuda): {secs:.3f} s, regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} (s, T) -> dF samples, "
          f"y_mean {d['y_mean']!r}, y_std {d['y_std']!r}", flush=True)
    # phase 1 again, part by part: the samples twice, the forest refitted
    setup, parts = FEDSPACE_SETUP, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    traj = timed("pretrain", lambda: pretrain_trajectory(
        fs.adapter, rounds=setup["pretrain_rounds"],
        clients_per_round=setup["clients_per_round"],
        local_steps=setup["local_steps"], client_lr=setup["client_lr"]))
    kw = dict(n_samples=setup["utility_samples"],
              local_steps=setup["local_steps"],
              client_lr=setup["client_lr"])
    X1, y1 = timed("samples", lambda: phase1_samples(fs.adapter, traj, **kw))
    X2, y2 = timed("samples", lambda: phase1_samples(fs.adapter, traj, **kw))
    if not (np.array_equal(X1, X2) and np.array_equal(y1, y2)):
        raise AssertionError("phase-1 samples differ between two "
                             "generations on the card")
    refit = timed("forest_fit", lambda: RandomForestRegressor(seed=0).fit(
        X1, y1)).arrays()
    fitted = fs.scheduler.regressor.arrays()
    if not all(np.array_equal(getattr(refit, f), getattr(fitted, f))
               for f in ("feature", "thresh", "left", "right", "value")):
        raise AssertionError("phase 1 repeated gives another forest")
    print(f"fedspace phase 1 (cuda): samples ({X1.shape[0]} x "
          f"{X1.shape[1]}) bit for bit alike in two generations, and the "
          f"forest refitted on them is the federation's; seconds by part "
          f"{json.dumps(parts)}", flush=True)
    p0 = params_to_numpy(fs.adapter.init(torch.Generator().manual_seed(
        fs.experiment.seed)))
    row = fedspace_experiment({**FEDSPACE_PARAMS,
                               "regressor": fs.scheduler.regressor})
    res, counts = _fedspace_runs(torch, row, fs, p0, "quickstart row")

    # (c)
    time_replans(torch, fs.scheduler.regressor,
                 res.val_loss[0] if res.val_loss else 4.0)
    return counts


def time_replans(torch, regressor, status):
    """Phase 6 (c): one re-plan's `score_candidates` (CUDA events over a
    few calls, after a warm-up), its device events and device time
    (`torch.profiler`), at the quickstart's shape (R 500, I0 24, K 40)
    and the paper's (R 5000, I0 24, K 191, the flock191 preset), from a
    random mid-run state; and the marks buffer's bytes, R·I0·K int8."""
    import numpy as np
    from repro_torch.core import connectivity as CN
    from repro_torch.core import search as SR
    from repro_torch.core import staleness as SS
    for name, spec, R, iters in (
            ("quickstart", CN.ConstellationSpec(num_satellites=40), 500, 20),
            ("paper", CN.constellation_preset("flock191"), 5000, 10)):
        I0 = FEDSPACE_PARAMS["I0"]
        C = CN.connectivity_sets(spec, days=0.25)[:I0]
        K = C.shape[1]
        r = np.random.default_rng(0)
        ig = 20
        state = SS.SatState(*(torch.as_tensor(
            r.integers(-1, ig + 1, K).astype(np.int32), device="cuda")
            for _ in range(3)))
        cands = SR.random_candidates(r, I0, 4, 8, R)

        def replan():
            return SR.score_candidates(cands, C, state, ig, regressor,
                                       status)
        scores = replan()
        if scores.shape != (R,) or not np.isfinite(scores).all():
            raise AssertionError(f"re-plan scores at {name}: not {R} "
                                 f"finite values")
        ms = _time_ms(replan, iters)
        host_us, dev_us, per_call, _, events, by_name = _host_and_device(
            replan, iters)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        row = {"shape": name, "R": R, "I0": I0, "K": K, "ms": ms,
               "host_us": host_us, "device_us": dev_us,
               "device_events_per_replan": per_call,
               "marks_bytes": R * I0 * K,
               "profiled": f"{events} kernel events over {iters} calls",
               "slowest_kernels_us_per_event": top}
        print("fedspace replan", json.dumps(row), flush=True)


# Part A of examples/satellite_fl_train.py: the paper's model family at the
# DenseNet adapter's own widths (28 leaves, N = 12,512), the first block
# frozen (paper §4.1), 48 satellites over 2 days, 144 windows.
DENSENET_WIDTHS = {"growth": 8, "blocks": (2, 2, 2), "stem": 16,
                   "frozen_blocks": 1}
DENSENET_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 300}
DENSENET_SETUP = {"pretrain_rounds": 10, "clients_per_round": 8,
                  "utility_samples": 40, "clients_per_sample": 6,
                  "local_steps": 8, "client_lr": 0.3}
# The card's run against the CPU's is chaotic: a ReLU input that rounds to
# 0 on one device and not on the other switches off that element's
# gradient, and the run's aggregations carry the difference on, as they
# carry a nudge of the initial model by one rounding (1e-7 relative) on
# one device. So the card is held to the CPU against that spread, measured
# on the card in the same call: its final model's drift from the CPU's
# (|a - b| / |b - p0|), and the largest gap between their accuracies, at
# most `CHAOS_FACTOR` times the card's own under the nudge (the
# accuracies also within one argmax flip of 600).
CHAOS_FACTOR = 3.0
# One step and 8 steps of a DenseNet client update at lr 0.3, card against
# CPU: one such ReLU moves a leaf by ~1.4e-4 a step, and 8-20 satellites
# hold many; `check_client_update` prints beside the difference how far
# each device's own update moves when its parameters move by one rounding.
DENSENET_STEP_TOL = 5e-3
DENSENET_UPDATE_TOL = 2e-2
# (a) runs over the first quarter day (24 of 144 windows: one evaluation),
# card against CPU; (b) over the first 48 (2 re-plans of the whole run's
# 6); both cut to keep the script inside its time limit
DENSENET_SHORT = 24
DENSENET_FEDSPACE_WINDOWS = 48


def densenet_experiment(scheduler):
    """Part A's world under `scheduler` (no target accuracy, so the run
    length cannot depend on floats)."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment,
                                    PartitionConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="satellite_fl_densenet",
        constellation=ConstellationConfig(num_satellites=48, days=2.0),
        dataset=DatasetConfig(num_train=3000, num_val=600, image_size=16,
                              noise=1.0),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="densenet", params=DENSENET_WIDTHS),
        scheduler=scheduler,
        train=EngineConfig(local_steps=8, client_lr=0.3, eval_every=24,
                           max_windows=144))


class Phase1Parts:
    """Seconds of FedSpace's phase 1 by part while the block runs (each
    ending in a synchronise): the pretrain, the eq.-12 samples and the
    forest's fit (`fit_utility_regressor` less its samples), by wrapping
    the functions `build_utility_regressor` calls through its module."""

    NAMES = ("pretrain_trajectory", "phase1_samples", "fit_utility_regressor")

    def __enter__(self):
        import torch
        from repro_torch.fl import fedspace_setup as FS
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self._inner = {n: getattr(FS, n) for n in self.NAMES}

        def timed(name, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                return out
            return run
        for name, fn in self._inner.items():
            setattr(FS, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import fedspace_setup as FS
        for name, fn in self._inner.items():
            setattr(FS, name, fn)

    def parts(self):
        s = self.seconds
        return {"pretrain": s["pretrain_trajectory"],
                "samples": s["phase1_samples"],
                "fit": s["fit_utility_regressor"] - s["phase1_samples"]}


def _drift(got, want, start) -> float:
    """|got - want| / |want - start| over the flattened leaves."""
    import numpy as np
    flat = [np.concatenate([np.ravel(x) for x in t])
            for t in (got, want, start)]
    return float(np.linalg.norm(flat[0] - flat[1])
                 / np.linalg.norm(flat[1] - flat[2]))


def run_densenet_path(torch):
    """Phase 7, the DenseNet path (Part A of
    examples/satellite_fl_train.py). (a) Part A's world under FedBuff
    (M 8) over its first DENSENET_SHORT windows on the card, launch
    counts read around it, again from the initial model nudged by one
    rounding, and on the CPU from the same initial model: counters and
    staleness histogram equal, the frozen leaves bit for bit the initial
    model on both devices, the card's
    final model and accuracies as near the CPU's as `CHAOS_FACTOR` times
    the nudge moves them on the card; (b) Part A as a user runs
    it, FedSpace with phase 1 on the card (its seconds by part, R^2), the
    run over its first DENSENET_FEDSPACE_WINDOWS windows (wall, counters,
    launches), then on the CPU with the same forest
    carried across: counters and every re-plan's schedule equal, or parted
    only on a forest split on T (ROADMAP C13); (c) one client update at M
    8 and M 20, card against CPU and twice on the card, then traced.
    Returns the launch counts of (a)'s and (b)'s card runs."""
    import math
    import numpy as np
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    counts = {}

    # (a)
    exp = densenet_experiment(SchedulerConfig(kind="fedbuff",
                                              params={"M": DENSENET_M}))
    fed = Federation.from_experiment(exp)
    p0 = params_to_numpy(fed.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    # the first DENSENET_SHORT windows, card against CPU (over the whole
    # horizon the CPU's run took 95-150 s, the card's 41-83 s)
    short = _first_windows(fed, DENSENET_SHORT)
    launch_counts.clear()
    t0 = time.perf_counter()
    eng = short.engine(init_params=p0)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["densenet fedbuff"] = dict(launch_counts)
    print("densenet fedbuff (cuda):", json.dumps(res.summary()), flush=True)
    print(f"densenet fedbuff (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, launches {counts['densenet fedbuff']}",
          flush=True)
    _one_launch_per_aggregation(res, counts["densenet fedbuff"])
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    start = tree_leaves(p0)
    frozen = [i for i, m in enumerate(tree_leaves(
        fed.adapter.trainable_mask(p0))) if m == 0.0]
    r = np.random.default_rng(0)
    nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
        a.shape))).astype(a.dtype), p0)
    t0 = time.perf_counter()
    nudged_eng = short.engine(init_params=nudged)
    nudged_res = nudged_eng.run()
    torch.cuda.synchronize()
    print(f"densenet fedbuff (cuda, first {DENSENET_SHORT} windows, "
          f"nudged): wall {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    cpu_fed = Federation.from_experiment(exp, device="cpu")
    cpu_eng = _first_windows(cpu_fed, DENSENET_SHORT).engine(
        init_params=p0, device="cpu")
    cpu = cpu_eng.run()
    print(f"densenet fedbuff (cpu, first {DENSENET_SHORT} windows): ",
          json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    _same_counters(res, cpu)
    _same_counters(res, nudged_res)
    card_final, cpu_final, nudged_final = (
        tree_leaves(params_to_numpy(e.params))
        for e in (eng, cpu_eng, nudged_eng))
    if not all(np.array_equal(f[i], start[i]) for i in frozen
               for f in (card_final, cpu_final)):
        raise AssertionError("a frozen leaf moved")
    drift = _drift(card_final, cpu_final, start)
    spread = _drift(nudged_final, card_final, start)
    gap = max(abs(a - b) for a, b in zip(res.accuracy, cpu.accuracy))
    acc_spread = max(abs(a - b) for a, b in zip(res.accuracy,
                                                nudged_res.accuracy))
    print(f"densenet fedbuff: {len(frozen)} frozen leaves bit for bit the "
          f"initial model on both devices; |card - CPU| / |CPU - p0| = "
          f"{drift!r}, the card's own under a 1e-7 nudge {spread!r}; "
          f"accuracies card {res.accuracy}, CPU {cpu.accuracy}, nudged "
          f"card {nudged_res.accuracy}: largest gap {gap!r}, the card's "
          f"own {acc_spread!r} (factor {CHAOS_FACTOR})", flush=True)
    if drift > CHAOS_FACTOR * spread or \
            gap > CHAOS_FACTOR * acc_spread + 1 / 600 + 1e-6:
        raise AssertionError("the card's run drifts from the CPU's beyond "
                             "its own spread")

    # (b)
    exp = densenet_experiment(SchedulerConfig(
        kind="fedspace", params=DENSENET_FEDSPACE, setup=DENSENET_SETUP))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Phase1Parts() as phase1:
        fs = Federation.from_experiment(exp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"densenet phase 1 (cuda): the world built in {secs:.3f} s, "
          f"phase 1 by part {json.dumps(phase1.parts())}; regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} (s, T) -> dF samples, y_mean "
          f"{d['y_mean']!r}, y_std {d['y_std']!r}", flush=True)
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card:
        res = _first_windows(fs, DENSENET_FEDSPACE_WINDOWS).run(
            init_params=p0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["densenet fedspace"] = dict(launch_counts)
    print("densenet fedspace (cuda):", json.dumps(res.summary()), flush=True)
    print(f"densenet fedspace (cuda): wall {wall:.3f} s, re-plans "
          f"{len(card.log)}, launches {counts['densenet fedspace']}",
          flush=True)
    _one_launch_per_aggregation(res, counts["densenet fedspace"])
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    reg = fs.scheduler.regressor
    fa = reg.arrays()
    carried = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                 fa.value, fa.depth,
                                 n_features=reg.n_features_)
    cpu_exp = densenet_experiment(SchedulerConfig(
        kind="fedspace", params={**DENSENET_FEDSPACE, "regressor": carried}))
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu = _first_windows(Federation.from_experiment(
            cpu_exp, device="cpu"), DENSENET_FEDSPACE_WINDOWS).run(
                init_params=p0)
    print("densenet fedspace (cpu): ", json.dumps(cpu.summary()),
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    both = list(zip(card.log, cpu_log.log))
    print(f"densenet fedspace: T at each re-plan, card and CPU: "
          f"{[(a['status'], b['status']) for a, b in both]}; "
          f"{int((fa.feature == T_FEATURE).sum())} forest splits on T",
          flush=True)
    # the runs' accuracies move apart as (a)'s do: printed, not held
    if _same_schedules(card.log, cpu_log.log, reg, t_split_ok=True) is None:
        _same_counters(res, cpu)
        print(f"densenet fedspace: {len(card.log)} re-plans, schedules and "
              f"counters equal, card against CPU", flush=True)

    # (c)
    for m in (DENSENET_M, MAIN_PATH_M):
        check_client_update(torch, fed.adapter, cpu_fed.adapter, exp.train,
                            m=m, tols=(DENSENET_STEP_TOL,
                                       DENSENET_UPDATE_TOL))
        step = trace_client_update(torch, fed.adapter, exp.train, m=m)
        print("densenet client step", json.dumps(step), flush=True)
    return counts


# The scenarios phase: link budgets and inter-satellite links, through the
# worlds of the repo's own examples. (a) examples/scheduler_comparison.py
# as written: starlink40, 4 days (384 windows), 6000/1200 samples at noise
# 2.2, non-IID, the MLP at hidden 48, E 16 at lr 1.0, eval every 24, the
# ISLConfig(100 Mbit/s, 600 MB, epoch 24), all 7 policies; (b) the binding
# cell of examples/isl_comparison.py: starlink40 over sparse1, 2 days (192
# windows), 4000/800 samples, the MLP at its default width (64), E 8 at lr
# 1.0, eval every 48, LinkConfig(20, 100, 600 MB, one satellite a station:
# need_up 4, need_dn 1), fedbuff M 12, intra_plane and isl_async, plus
# FedSpace on the same budget (the link-gated search) with (a)'s forest.
SCENARIO_POLICIES = (("sync", {}), ("async", {}), ("fedbuff", {"M": 20}),
                     ("periodic", {"period": 4}), ("intra_plane", {}),
                     ("isl_async", {}))
SCENARIO_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 800}
SCENARIO_SETUP = {"pretrain_rounds": 30, "clients_per_round": 16,
                  "utility_samples": 150, "local_steps": 16,
                  "client_lr": 1.0}
ISL_CELL_POLICIES = (("fedbuff", {"M": 12}), ("intra_plane", {}),
                     ("isl_async", {}))
# (a)'s chaos-held policies (an aggregation nearly every window, each run
# also held against a nudged card run) run the world's first quarter day
# (one evaluation; half a day until the train phase's recurrentgemma-9b
# step came), fedbuff and periodic its first day, which keeps the whole
# script inside its time limit.
SCENARIO_SHORT = {"async": 24, "isl_async": 24, "fedbuff": 96,
                  "periodic": 96}
# Accuracy card against CPU, at every evaluation: within 0.01 (as the
# quickstart path); where a run is chaotic (one update an aggregation at lr
# 1.0 carries a rounding difference on and grows it: ROADMAP C16) and the
# gap is wider, within CHAOS_FACTOR times the gap a nudge of the initial
# model by one rounding makes on the card, plus one argmax flip.
SCENARIO_ACC_TOL = 0.01
# the policies whose card run is also held to the card's host loop
# (periodic's pair runs in the `gpu` test of the fast loop,
# tests/test_torch_device.py)
SCENARIO_HOST_PAIRS = ("sync",)


def _first_windows(fed, windows):
    """`fed` with its runs cut to their first `windows` windows: the same
    world, a shorter horizon."""
    import copy
    import dataclasses
    out = copy.copy(fed)
    out.experiment = dataclasses.replace(fed.experiment, train=(
        dataclasses.replace(fed.experiment.train, max_windows=windows)))
    return out


def scheduler_comparison_experiment():
    """examples/scheduler_comparison.py's world, as written."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment, ISLConfig,
                                    PartitionConfig, SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="scheduler_comparison",
        constellation=ConstellationConfig(preset="starlink40", days=4.0),
        dataset=DatasetConfig(num_train=6000, num_val=1200, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="sync"),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=24,
                           max_windows=384),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


def isl_cell_experiment():
    """examples/isl_comparison.py's binding cell: starlink40 over sparse1
    under the finite budget."""
    from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                    FLExperiment, ISLConfig, LinkConfig,
                                    SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="isl_comparison",
        constellation=ConstellationConfig(preset="starlink40",
                                          ground="sparse1", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 12}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=192),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=1),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


def _columns(eng):
    """The engine's protocol state as host lists, the link and ISL
    columns among them (None where the run has none)."""
    return {name: (None if getattr(eng, name) is None
                   else getattr(eng, name).tolist())
            for name in ("version", "pending", "buffered_base",
                         "transfer_progress", "relay_units")}


def _scenario_pair(torch, tag, card_fed, cpu_fed, p0, counts,
                   regressor=None, host_pair=False):
    """One policy (`tag` leads its lines): the card's run (launch counts
    read around it, wall, the fast loop's counts), with `host_pair` the
    card's host-loop run held to it (`_strategies`), then the CPU's from
    the same initial model;
    every counter, the staleness histogram and the final protocol columns
    equal (for
    FedSpace, every re-plan under the C13 rule, and the rest where the
    schedules agree), the accuracies within `SCENARIO_ACC_TOL` or the
    card's own chaos. Returns (card result, card wall, CPU wall)."""
    import math
    import numpy as np
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_map
    launch_counts.clear()
    t0 = time.perf_counter()
    with Replans() as card_log, LoopStats(torch) as stats:
        eng = card_fed.engine(init_params=p0)
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mine = dict(launch_counts)
    for k, v in mine.items():
        counts[k] = counts.get(k, 0) + v
    print(f"{tag} (cuda):", json.dumps(res.summary()), flush=True)
    print(f"{tag} (cuda): wall {wall:.3f} s, windows "
          f"{res.windows_run}, re-plans {len(card_log.log)}, launches "
          f"{mine}, loop {json.dumps(stats.line(eng))}", flush=True)
    _one_launch_per_aggregation(res, mine)
    if not all(math.isfinite(a) for a in res.accuracy + res.val_loss):
        raise AssertionError("non-finite accuracy or loss on the card")
    if host_pair:
        _strategies(torch, tag, card_fed, eng, res, stats, init_params=p0)
    t0 = time.perf_counter()
    with Replans() as cpu_log:
        cpu_eng = cpu_fed.engine(init_params=p0, device=cpu_fed.device)
        cpu = cpu_eng.run()
    cpu_wall = time.perf_counter() - t0
    print(f"{tag} (cpu): {json.dumps(cpu.summary())} wall "
          f"{cpu_wall:.3f} s", flush=True)
    card_cols, cpu_cols = _columns(eng), _columns(cpu_eng)
    print(f"{tag}: final progress card "
          f"{card_cols['transfer_progress']} CPU "
          f"{cpu_cols['transfer_progress']}; relay card "
          f"{card_cols['relay_units']} CPU {cpu_cols['relay_units']}",
          flush=True)
    if regressor is not None:
        if _same_schedules(card_log.log, cpu_log.log, regressor,
                           t_split_ok=True) is not None:
            return res, wall, cpu_wall
        print(f"{tag}: {len(card_log.log)} re-plans, schedules "
              f"equal, card against CPU", flush=True)
    _same_counters(res, cpu)
    if card_cols != cpu_cols:
        raise AssertionError(f"{tag}: protocol columns differ")
    gap = max(abs(a - b) for a, b in zip(res.accuracy, cpu.accuracy))
    if gap <= SCENARIO_ACC_TOL:
        print(f"{tag}: counters, histogram and columns equal; "
              f"accuracies within {gap!r} (tolerance {SCENARIO_ACC_TOL})",
              flush=True)
        return res, wall, cpu_wall
    r = np.random.default_rng(0)
    nudged = tree_map(lambda a: (a * (1 + 1e-7 * r.standard_normal(
        a.shape))).astype(a.dtype), p0)
    nres = card_fed.engine(init_params=nudged).run()
    spread = max(abs(a - b) for a, b in zip(res.accuracy, nres.accuracy))
    print(f"{tag}: counters, histogram and columns equal; "
          f"accuracies card {res.accuracy} CPU {cpu.accuracy} nudged card "
          f"{nres.accuracy}: gap {gap!r}, the card's own {spread!r} "
          f"(factor {CHAOS_FACTOR})", flush=True)
    if gap > CHAOS_FACTOR * spread + \
            1 / card_fed.experiment.dataset.num_val + 1e-6:
        raise AssertionError(f"{tag}: accuracy gap beyond the "
                             f"card's own spread")
    return res, wall, cpu_wall


def time_gated_replans(torch, fed, regressor, status, iters=20):
    """One re-plan's `score_candidates` at (b)'s shape (R 800, I0 24, K 40)
    on the card, CUDA events over `iters` calls after a warm-up, with the
    budget's gate over its served connectivity and without one over the
    geometric, from one random mid-run state."""
    import numpy as np
    from repro_torch.core import search as SR
    from repro_torch.core import staleness as SS
    b = fed.link_budget
    I0, R = SCENARIO_FEDSPACE["I0"], SCENARIO_FEDSPACE["num_candidates"]
    K = b.served.shape[1]
    r = np.random.default_rng(0)
    ig = 20
    cols = [torch.as_tensor(r.integers(-1, ig + 1, K).astype(np.int32),
                            device=fed.device) for _ in range(3)]
    progress = torch.as_tensor(r.integers(0, b.need_up, K).astype(np.int32),
                               device=fed.device)
    cands = SR.random_candidates(r, I0, 4, 8, R)
    gate = SS.LinkGate(b.grants[:I0], b.need_up, b.need_dn)
    row = {"R": R, "I0": I0, "K": K}
    for name, C, state, link in (
            ("gated", b.served[:I0], SS.SatState(*cols, progress=progress),
             gate),
            ("geometry", b.visible[:I0], SS.SatState(*cols), None)):
        def replan():
            return SR.score_candidates(cands, C, state, ig, regressor,
                                       status, link=link)
        if not np.isfinite(replan()).all():
            raise AssertionError(f"{name} re-plan scores not finite")
        row[f"{name}_ms"] = _time_ms(replan, iters)
    print("scenarios replan", json.dumps(row), flush=True)


def run_scenarios_path(torch):
    """Phase 8, the scenarios (`scenarios` lines): (a) every policy of
    examples/scheduler_comparison.py on its world, card against CPU
    (`_scenario_pair`), FedSpace with phase 1 on the card (its seconds)
    and the CPU with the forest carried across; (b) the binding cell of
    examples/isl_comparison.py (its blocked share), the three policies and
    FedSpace under the budget, card against CPU, the final `progress` and
    `relay` columns printed; (c) a re-plan's time with and without the
    gate. Returns the launch counts summed over the card's runs."""
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    counts, walls = {}, {}
    t_phase = time.perf_counter()

    # (a)
    exp = scheduler_comparison_experiment()
    base = Federation.from_experiment(exp)
    cpu_base = Federation.from_experiment(exp, device="cpu")
    p0 = params_to_numpy(base.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    for name, kw in SCENARIO_POLICIES:
        card_w, cpu_w = base, cpu_base
        if name in SCENARIO_SHORT:
            card_w, cpu_w = (_first_windows(w, SCENARIO_SHORT[name])
                             for w in (base, cpu_base))
        _, card, cpu = _scenario_pair(
            torch, f"scenarios (a) {name}", card_w.with_scheduler(name, **kw),
            cpu_w.with_scheduler(name, **kw), p0, counts,
            host_pair=name in SCENARIO_HOST_PAIRS)
        walls[f"(a) {name}"] = (card, cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Phase1Parts() as phase1:
        fs = base.with_scheduler(SchedulerConfig(
            "fedspace", params=SCENARIO_FEDSPACE, setup=SCENARIO_SETUP))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = fs.scheduler_diag
    print(f"scenarios (a) phase 1 (cuda): {secs:.3f} s, by part "
          f"{json.dumps(phase1.parts())}; regressor R^2="
          f"{d['r2_in_sample']!r} on {d['n']} samples", flush=True)
    reg = fs.scheduler.regressor
    fa = reg.arrays()
    carried = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                 fa.value, fa.depth,
                                 n_features=reg.n_features_)
    fs_params = {**SCENARIO_FEDSPACE, "regressor": carried}
    res, card, cpu = _scenario_pair(
        torch, "scenarios (a) fedspace", fs,
        cpu_base.with_scheduler(SchedulerConfig("fedspace",
                                                params=fs_params)),
        p0, counts, regressor=reg)
    walls["(a) fedspace"] = (card, cpu)
    status = res.val_loss[0] if res.val_loss else 4.0

    # (b)
    exp = isl_cell_experiment()
    cell = Federation.from_experiment(exp)
    cpu_cell = Federation.from_experiment(exp, device="cpu")
    b = cell.link_budget
    print(f"scenarios (b): starlink40 over sparse1, need_up {b.need_up}, "
          f"need_dn {b.need_dn}, blocked_fraction {b.blocked_fraction()!r}"
          f" (CPU {cpu_cell.link_budget.blocked_fraction()!r}), relay "
          f"windows {cell.isl.relay_windows}", flush=True)
    p0 = params_to_numpy(cell.adapter.init(torch.Generator().manual_seed(
        exp.seed)))
    for name, kw in ISL_CELL_POLICIES:
        _, card, cpu = _scenario_pair(
            torch, f"scenarios (b) {name}", cell.with_scheduler(name, **kw),
            cpu_cell.with_scheduler(name, **kw), p0, counts)
        walls[f"(b) {name}"] = (card, cpu)
    fs_card = {**SCENARIO_FEDSPACE, "regressor": reg}
    _, card, cpu = _scenario_pair(
        torch, "scenarios (b) fedspace",
        cell.with_scheduler(SchedulerConfig("fedspace", params=fs_card)),
        cpu_cell.with_scheduler(SchedulerConfig("fedspace",
                                                params=fs_params)),
        p0, counts, regressor=reg)
    walls["(b) fedspace"] = (card, cpu)

    # (c)
    time_gated_replans(torch, cell, reg, status)
    print("scenarios walls (card s, CPU s)", json.dumps(walls), flush=True)
    print(f"scenarios: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"scenarios": counts}


# examples/fault_study.py's world, as written: starlink40 over dense12, 2
# days (192 windows), 4000/800 samples at noise 2.2, the MLP at its default
# width (64), E 8 at lr 1.0, eval every 48, LinkConfig(20, 100, 600 MB, two
# satellites a station), ISLConfig(100 Mbit/s, 600 MB, epoch 24); its five
# fault worlds; sync, fedbuff M 10 and intra_plane M 10 through the sweep,
# and FedSpace (I0 24, 4-8 aggregations, 512 candidates; phase 1 of 10
# rounds of 12 clients and 60 samples at E 8, lr 1.0) run one by one.
FAULT_K, FAULT_G, FAULT_WINDOWS = 40, 12, 192
# (b)'s FedSpace runs over the worlds' first half day (2 re-plans; a day
# until the train phase's recurrentgemma-9b step came), a cut that keeps
# the whole script inside its time limit
FAULT_FEDSPACE_WINDOWS = 48
FAULT_SWEEPABLE = (("sync", {}), ("fedbuff", {"M": FAULT_M}),
                   ("intra_plane", {"M": FAULT_M}))
FAULT_FEDSPACE = {"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 512}
FAULT_SETUP = {"pretrain_rounds": 10, "clients_per_round": 12,
               "utility_samples": 60, "local_steps": 8, "client_lr": 1.0}
# one sequential `.run()` a policy and a fault kind, held to the sweep
FAULT_SEQUENTIAL = (("churn40", "fedbuff"), ("blackout", "intra_plane"),
                    ("weather", "sync"))


def fault_scenarios():
    """examples/fault_study.py's five fault worlds, in its order."""
    from repro_torch.core.faults import random_churn, station_blackout
    from repro_torch.fl.api import FaultConfig
    K, G, W = FAULT_K, FAULT_G, FAULT_WINDOWS
    return (("clean", FaultConfig()),
            ("churn20", FaultConfig(deorbit=random_churn(K, W, 0.20,
                                                         seed=0))),
            ("churn40", FaultConfig(deorbit=random_churn(K, W, 0.40,
                                                         seed=0))),
            ("blackout", FaultConfig(outages=station_blackout(G, 64, 128))),
            ("weather", FaultConfig(rate_scale_min=0.25, rate_scale_max=1.0,
                                    seed=1)))


def fault_study_experiment():
    """examples/fault_study.py's base world, as written."""
    from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                    FLExperiment, ISLConfig, LinkConfig,
                                    SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        name="fault_study",
        constellation=ConstellationConfig(preset="starlink40",
                                          ground="dense12", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": FAULT_M}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=FAULT_WINDOWS),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=2),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24))


class SweepLoops:
    """While the block runs: the number of window loops (groups) the
    sweep runs, each loop on the card under
    `torch.cuda.set_sync_debug_mode("error")`, so that a host read inside
    it fails."""

    def __enter__(self):
        import torch
        from repro_torch.fl import sweep
        self.groups, self._loop = 0, sweep._window_loop

        def loop(cols, **kw):
            self.groups += 1
            on_card = cols["C"].is_cuda
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                if self.groups == 1:      # the guard is live: a read fails
                    try:
                        cols["C"][0, 0, 0].item()
                    except RuntimeError:
                        pass
                    else:
                        raise AssertionError("sync debug mode let .item() "
                                             "through")
            try:
                return self._loop(cols, **kw)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        sweep._window_loop = loop
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import sweep
        sweep._window_loop = self._loop


class Phase1Count:
    """Counts the FedSpace phase-1 builds `Federation` runs while the block
    runs (`build_utility_regressor`, called through `fl/api.py`)."""

    def __enter__(self):
        from repro_torch.fl import api
        self.calls, self._inner = 0, api.build_utility_regressor

        def counted(*args, **kw):
            self.calls += 1
            return self._inner(*args, **kw)
        api.build_utility_regressor = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.fl import api
        api.build_utility_regressor = self._inner


def _fault_row(res):
    """examples/fault_study.py's row numbers: idle %, updates, gradients,
    mean staleness."""
    hist = res.staleness_hist
    stale = sum(s * int(n) for s, n in enumerate(hist)) / max(
        int(hist.sum()), 1)
    return {"idle_pct": 100.0 * res.idle_connections
            / max(res.total_connections, 1),
            "updates": res.num_global_updates,
            "grads": res.num_aggregated_gradients, "stale": stale}


def _same_outcomes(card, cpu, tag):
    """Two sweep outcomes (or a run and an outcome) equal in every
    counter, the histogram and the final columns."""
    for name in ("num_global_updates", "num_aggregated_gradients",
                 "idle_connections", "total_connections", "windows_run"):
        a, b = getattr(card.result, name), getattr(cpu.result, name)
        if a != b:
            raise AssertionError(f"{tag}: {name} {a} against {b}")
    if card.result.staleness_hist.tolist() != \
            cpu.result.staleness_hist.tolist():
        raise AssertionError(f"{tag}: staleness histograms differ")
    for name in ("version", "pending", "buffered"):
        if getattr(card, name).tolist() != getattr(cpu, name).tolist():
            raise AssertionError(f"{tag}: final {name} differs")


def run_faults_path(torch):
    """Phase 9, the fault study (`faults` lines), examples/fault_study.py's
    world on the card against the CPU: (a) the 15 sweepable cells through
    `sweep_engines` on both (groups, walls; every outcome equal; the card's
    window loops under the sync guard; no kernel launched), and three
    cells run one by one through the card's `.run()`, held to the sweep;
    (b) FedSpace under each fault world (blind) and under churn40 as an
    oracle, phase 1 once on the card and the forest carried to the CPU
    (`_scenario_pair`: counters, columns, schedules under C13, one
    aggregation launch per aggregation); (c) the traces' numbers. Returns
    the launch counts summed over the card's runs."""
    import dataclasses
    from types import SimpleNamespace
    import numpy as np
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.fl.sweep import sweep_engines
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.agg.ops import FlatLayout
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import forest_from_arrays, params_to_numpy
    t_phase = time.perf_counter()
    exp = fault_study_experiment()
    scen = fault_scenarios()
    clean = Federation.from_experiment(exp)
    cpu_clean = Federation.from_experiment(exp, device="cpu")
    worlds = {n: clean.with_faults(c) for n, c in scen}
    cpu_worlds = {n: cpu_clean.with_faults(c) for n, c in scen}

    # (c) the traces: alive satellites at the end, contacts and grant
    # units the faults remove from the served world
    W = FAULT_WINDOWS
    for name, _ in scen:
        eng, cpu_eng = worlds[name].engine(), cpu_worlds[name].engine(
            device="cpu")
        if not (np.array_equal(eng.C, cpu_eng.C)
                and np.array_equal(eng._grants, cpu_eng._grants)):
            raise AssertionError(f"faults (c) {name}: the executed worlds "
                                 f"differ, card against CPU")
        tr = worlds[name].faults
        row = {"alive_at_end": FAULT_K if tr is None
               else int(tr.alive[W - 1].sum()),
               "contacts_removed": 1 - eng.C[:W].sum()
               / eng._plan_C[:W].sum(),
               "grant_loss": 1 - eng._grants[:W].sum()
               / eng._plan_grants[:W].sum()}
        print(f"faults (c) {name}:", json.dumps(
            {k: float(v) for k, v in row.items()}), flush=True)

    # (a) the sweep, card then CPU
    cells = [(n, kind, kw) for n, _ in scen for kind, kw in FAULT_SWEEPABLE]
    swept = {}
    for side, ws in (("cuda", worlds), ("cpu", cpu_worlds)):
        launch_counts.clear()
        with SweepLoops() as loops:
            t0 = time.perf_counter()
            # `run_sweep` is this call over the worlds' engines; its
            # outcomes keep the final columns compared below
            swept[side] = sweep_engines([
                w.engine(device=w.device) for w in
                (ws[n].with_scheduler(kind, **kw) for n, kind, kw in cells)])
            if side == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if side == "cuda" and sum(launch_counts.values()):
            raise AssertionError(f"the sweep launched kernels: "
                                 f"{dict(launch_counts)}")
        print(f"faults (a) sweep ({side}): {len(cells)} cells in "
              f"{loops.groups} groups, wall {wall:.3f} s"
              + (", window loops under sync debug mode 'error'"
                 if side == "cuda" else ""), flush=True)
    for (n, kind, _), card, cpu in zip(cells, swept["cuda"], swept["cpu"]):
        _same_outcomes(card, cpu, f"faults (a) {n} {kind}")
        print(f"faults (a) {n} {kind}:", json.dumps(_fault_row(card.result)),
              flush=True)
    print(f"faults (a): {len(cells)} outcomes equal, card against CPU",
          flush=True)
    counts = {}
    init = clean.adapter.init(torch.Generator().manual_seed(exp.seed))
    n = FlatLayout.of(tree_leaves(init)).size
    if n != FAULT_N:
        raise AssertionError(f"the fault study's flat model holds {n}, "
                             f"check_aggregation's FAULT_N {FAULT_N}")
    p0 = params_to_numpy(init)
    for name, kind in FAULT_SEQUENTIAL:
        kw = dict(FAULT_SWEEPABLE)[kind]
        launch_counts.clear()
        t0 = time.perf_counter()
        eng = worlds[name].with_scheduler(kind, **kw).engine(init_params=p0)
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mine = dict(launch_counts)
        for k, v in mine.items():
            counts[k] = counts.get(k, 0) + v
        _one_launch_per_aggregation(res, mine)
        (out,) = [o for (n, k, _), o in zip(cells, swept["cuda"])
                  if (n, k) == (name, kind)]
        _same_outcomes(SimpleNamespace(result=res, version=eng.version,
                                       pending=eng.pending,
                                       buffered=eng.buffered_base), out,
                       f"faults (a) {name} {kind} run")
        print(f"faults (a) {name} {kind} (cuda) run: wall {wall:.3f} s, "
              f"{res.num_global_updates} aggregations, launches {mine}; "
              f"equal to the sweep", flush=True)

    # (b) FedSpace under the faults: phase 1 once, on the card
    walls = {}
    fs_cfg = SchedulerConfig("fedspace", params=FAULT_FEDSPACE,
                             setup=FAULT_SETUP)
    with Phase1Count() as phase1:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg = clean.with_scheduler(fs_cfg).scheduler.regressor
        torch.cuda.synchronize()
        print(f"faults (b) phase 1 (cuda): {time.perf_counter() - t0:.3f} s",
              flush=True)
        fa = reg.arrays()
        carried = forest_from_arrays(fa.feature, fa.thresh, fa.left,
                                     fa.right, fa.value, fa.depth,
                                     n_features=reg.n_features_)
        cpu_cfg = SchedulerConfig("fedspace", params={
            **FAULT_FEDSPACE, "regressor": carried})
        runs = [(n, c) for n, c in scen] + [
            ("churn40 oracle", dataclasses.replace(dict(scen)["churn40"],
                                                   oracle=True))]
        for label, cfg in runs:
            _, card, cpu = _scenario_pair(
                torch, f"faults (b) {label}", *(
                    _first_windows(w.with_faults(cfg).with_scheduler(c),
                                   FAULT_FEDSPACE_WINDOWS)
                    for w, c in ((clean, fs_cfg), (cpu_clean, cpu_cfg))),
                p0, counts, regressor=reg)
            walls[label] = (card, cpu)
    if phase1.calls != 1:
        raise AssertionError(f"phase 1 ran {phase1.calls} times")
    print("faults (b) walls (card s, CPU s)", json.dumps(walls), flush=True)
    print(f"faults: phase 1 ran once; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"faults": counts}


# The compression phase. (a) the uplink roundtrips card against CPU on
# update trees of the paths' payloads (the transformer's leaves at M 20,
# Part A's DenseNet at M 8, its frozen leaves 0), then timed on one flat
# leaf of the paper's size; (b) part (b) of the `payloads` section of
# benchmarks/hotpaths.py as written: starlink40 over sparse1, 2 days (192
# windows), LinkConfig(20, 100, model MB, one satellite a station),
# 600/200 samples, E 2, {mlp hidden 64 at 300 MB, transformer default at
# 600 MB} x {off, top-k 0.25, int8} x {fedbuff M 2, async}, card and CPU;
# each run over the first half day (STUDY_WINDOWS), a cut that keeps the
# whole script inside its time limit (96 windows until the train phase's
# recurrentgemma-9b step came).
COMPRESSION_TOPK = 0.25
STUDY_WINDOWS = 48
STUDY_MODELS = (("mlp", {"hidden": 64}, 300.0), ("transformer", {}, 600.0))
STUDY_COMPRESSION = (("off", {}), ("topk25", {"uplink_topk": 0.25}),
                     ("int8", {"uplink_int8": True}))
STUDY_SCHEDULERS = (("fedbuff", {"M": 2}), ("async", {}))


def _payload_leaves(torch, kind, params):
    """The leaves (tree order) of a payload's initial model on the CPU,
    and the trainable mask's flags (None without one)."""
    import repro_torch.fl.adapters  # noqa: F401 — registers the adapters
    from repro_torch.data.fmow import FmowSpec, SyntheticFmow
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.pipeline import make_clients
    from repro_torch.fl.registry import ADAPTERS
    from repro_torch.tree import tree_leaves
    image = {"image_size": 16} if kind == "densenet" else {}
    data = SyntheticFmow(FmowSpec(num_train=64, num_val=16, **image))
    adapter = ADAPTERS.build(kind, data,
                             make_clients(iid_partition(64, 4, 0)),
                             device="cpu", **params)
    p = adapter.init(torch.Generator().manual_seed(0))
    if not hasattr(adapter, "trainable_mask"):
        return tree_leaves(p), None
    return tree_leaves(p), [float(m) for m in tree_leaves(
        adapter.trainable_mask(p))]


def _roundtrip_pair(torch, name, leaves, flags, m):
    """Both roundtrips of seeded (m, n) update rows of every leaf, card
    against CPU: the kept index sets equal, the dequantized values within
    one quantum, frozen leaves (flag 0, their rows 0) exactly 0. Returns
    the largest difference over the leaves, in quanta."""
    import numpy as np
    from repro_torch.fl import compression as TC
    r = np.random.default_rng(7)
    worst = 0.0
    for j, leaf in enumerate(leaves):
        n = leaf.numel()
        rows = r.standard_normal((m, n)).astype(np.float32) * 0.01
        frozen = flags is not None and flags[j] == 0.0
        if frozen:
            rows[:] = 0.0
        cpu_in = torch.as_tensor(rows)
        card_in = cpu_in.to("cuda")
        k = max(1, int(n * COMPRESSION_TOPK))
        keep = [TC._topk_mask(x.abs(), k).cpu() for x in (card_in, cpu_in)]
        if not torch.equal(*keep):
            raise AssertionError(f"{name} leaf {j}: kept index sets differ")
        scale = (cpu_in.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
                 / 127.0)
        for fn in (lambda x: TC.roundtrip_rows(x, COMPRESSION_TOPK),
                   TC.roundtrip_int8_rows):
            a, b = fn(card_in).cpu(), fn(cpu_in)
            quanta = float(((a - b).abs() / scale).max())
            worst = max(worst, quanta)
            if quanta > 1.0:
                raise AssertionError(f"{name} leaf {j}: {quanta} quanta "
                                     f"apart")
            if frozen and (a.any() or b.any()):
                raise AssertionError(f"{name} frozen leaf {j} moved")
    return worst


def study_experiment(kind, params, model_mb, scheduler, sched_params,
                     compression):
    """One cell of the bytes-on-the-wire study (benchmarks/hotpaths.py's
    `_payload_exp` at the study's settings)."""
    from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                    DatasetConfig, FLExperiment, LinkConfig,
                                    SchedulerConfig)
    from repro_torch.fl.engine import EngineConfig
    return FLExperiment(
        constellation=ConstellationConfig(num_satellites=10, days=2.0,
                                          preset="starlink40",
                                          ground="sparse1"),
        dataset=DatasetConfig(num_train=600, num_val=200),
        adapter=AdapterConfig(kind=kind, params=dict(params)),
        scheduler=SchedulerConfig(kind=scheduler,
                                  params=dict(sched_params)),
        train=EngineConfig(eval_every=STUDY_WINDOWS,
                           max_windows=STUDY_WINDOWS, local_steps=2),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=model_mb, gs_capacity=1, **compression))


def _add(total, counts):
    for key, v in counts.items():
        total[key] = total.get(key, 0) + v


def run_compression_path(torch):
    """The compression phase, (a) and (b) above. Returns the launch counts
    of the study's card runs."""
    import math
    from repro_torch.fl import compression as TC
    from repro_torch.fl.api import Federation
    from repro_torch.kernels import launch_counts
    t_phase = time.perf_counter()
    # (a)
    for name, kind, params, m in (
            ("transformer", "transformer", {}, MAIN_PATH_M),
            ("densenet", "densenet", DENSENET_WIDTHS, DENSENET_M)):
        leaves, flags = _payload_leaves(torch, kind, params)
        worst = _roundtrip_pair(torch, name, leaves, flags, m)
        print(f"compression (a) {name}: {len(leaves)} leaves at M {m}, "
              f"N {sum(x.numel() for x in leaves)}: kept index sets equal "
              f"card and CPU, largest difference {worst!r} quanta"
              + ("" if flags is None else
                 f", {flags.count(0.0)} frozen leaves 0 on both"),
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((MAIN_PATH_M, PAPER_N), generator=g, device="cuda")
    bound = 2 * x.numel() * 4 / cost.HBM_BYTES_PER_S * 1e3
    for label, fn in (
            (f"top-k {COMPRESSION_TOPK}",
             lambda: TC.roundtrip_rows(x, COMPRESSION_TOPK)),
            ("int8", lambda: TC.roundtrip_int8_rows(x))):
        ms = _time_ms(fn, 5)
        print("compression (a) paper", json.dumps({
            "roundtrip": label, "M": MAIN_PATH_M, "N": PAPER_N,
            "bytes": x.numel() * 4, "ms": ms, "bound_ms": bound,
            "bound_by": "bytes", "share_of_bound": bound / ms}),
            flush=True)
    del x
    torch.cuda.empty_cache()

    # (b)
    counts, cells = {}, {}
    for kind, params, mb in STUDY_MODELS:
        for cname, comp in STUDY_COMPRESSION:
            for sname, skw in STUDY_SCHEDULERS:
                tag = f"{kind}/{cname}/{sname}"
                exp = study_experiment(kind, params, mb, sname, skw, comp)
                launch_counts.clear()
                t0 = time.perf_counter()
                fed = Federation.from_experiment(exp)
                res = fed.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = dict(launch_counts)
                _add(counts, c)
                _one_launch_per_aggregation(res, c)
                if kind == "transformer" and not all(c.get(k) for k in (
                        "rmsnorm", "rmsnorm_bwd", "flash_attention",
                        "flash_attention_bwd")):
                    raise AssertionError(f"{tag}: RMSNorm and attention "
                                         f"not launched: {c}")
                if not all(math.isfinite(a) for a in res.accuracy
                           + res.val_loss):
                    raise AssertionError(f"{tag}: non-finite on the card")
                t0 = time.perf_counter()
                cpu = Federation.from_experiment(exp, device="cpu").run()
                cpu_wall = time.perf_counter() - t0
                _same_counters(res, cpu)
                b = fed.link_budget
                cells[tag] = {
                    "need_up": b.need_up, "need_dn": b.need_dn,
                    "bytes_ratio": TC.uplink_bytes_ratio(
                        comp.get("uplink_topk", 0.0),
                        int8=comp.get("uplink_int8", False)),
                    "global_updates": res.num_global_updates,
                    "aggregated_gradients": res.num_aggregated_gradients,
                    "idle_fraction": res.idle_connections
                    / max(res.total_connections, 1),
                    "accuracy_card": res.accuracy[-1],
                    "accuracy_cpu": cpu.accuracy[-1],
                    "wall_card_s": wall, "wall_cpu_s": cpu_wall,
                    "launches": c}
                print(f"compression (b) {tag}", json.dumps(cells[tag]),
                      flush=True)
    models = [k for k, _, _ in STUDY_MODELS]
    scheds = [s for s, _ in STUDY_SCHEDULERS]
    for mname in models:
        for s in scheds:
            off = cells[f"{mname}/off/{s}"]
            for cname in ("topk25", "int8"):
                cell = cells[f"{mname}/{cname}/{s}"]
                if not cell["need_up"] < off["need_up"]:
                    raise AssertionError(f"{mname}/{cname}/{s}: need_up "
                                         f"{cell['need_up']} not below "
                                         f"{off['need_up']}")
                if cell["need_dn"] != off["need_dn"]:
                    raise AssertionError(f"{mname}/{cname}/{s}: need_dn "
                                         f"moved")
    if not any(cells[f"{m}/{c}/{s}"]["aggregated_gradients"]
               != cells[f"{m}/off/{s}"]["aggregated_gradients"]
               for m in models for c in ("topk25", "int8") for s in scheds):
        raise AssertionError("compression shifted no aggregated-gradient "
                             "count")
    print(f"compression (b): 12 cells card = CPU in every counter and "
          f"histogram, need_up lower with compression in every model and "
          f"scheduler, need_dn unchanged; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"compression": counts}


# The replan phase: the serving shape of the `replan` section of
# benchmarks/hotpaths.py (K 1000, R 20000, I0 24, 4-8 aggregations,
# min_pool 256, 8 consecutive windows of Bernoulli(0.15) connectivity)
# on the card; a small shape card against CPU; and the quickstart's
# FedSpace row routed through a service.
REPLAN_SERVING = {"K": 1000, "R": 20_000, "I0": 24, "min_pool": 256}
REPLAN_SMALL = {"K": 40, "R": 2000, "I0": 12, "min_pool": 64}
REPLAN_STEPS = 8


def _search_forest(s_max=8, n_trees=40, seed=0):
    """benchmarks/hotpaths.py's `_fit_search_regressor`, fitted by the
    port: a forest over simulator staleness histograms against a
    count-utility curve."""
    import numpy as np
    from repro_torch.core.utility import RandomForestRegressor, featurize
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 25, (600, s_max + 1)).astype(np.float32)
    X = featurize(hists, 1.0)
    s = np.arange(s_max + 1, dtype=np.float32)
    y = ((hists * (1.2 - 0.3 * s)).sum(1)
         / np.maximum(hists.sum(1), 1.0)
         + 0.05 * rng.normal(size=len(X))).astype(np.float32)
    return RandomForestRegressor(n_trees=n_trees, max_depth=6,
                                 seed=seed).fit(X, y)


def _serve(torch, rf, shape, device, *, gate=False, profile=False):
    """REPLAN_STEPS consecutive re-plans of one service on `device` (the
    benchmark's seeds: connectivity 0, service 3, draws 7), each answer
    realized against the true protocol state. With `gate`, each answer is
    held against a full `score_candidates` + `select_candidate` rescan of
    the live pool; answers, rescans and `maintain()` are timed on the host
    clock (each ends with the scores on the host or a synchronise); with
    `profile`, each answer is traced instead. Returns the log (mode,
    reason, plan, pool) per step, the stats and the timings."""
    import numpy as np
    from repro_torch.core import staleness as SS
    from repro_torch.core.search import score_candidates, select_candidate
    from repro_torch.fl.replan import ReplanService
    K, R, I0 = shape["K"], shape["R"], shape["I0"]
    C = np.random.default_rng(0).random((I0 + REPLAN_STEPS, K)) < 0.15
    svc = ReplanService(rf, I0=I0, num_candidates=R, n_min=4, n_max=8,
                        seed=3, min_pool=shape["min_pool"])
    state = SS.bootstrap_state(K, device=device)
    ig, draw = 0, np.random.default_rng(7)
    log, times = [], {"delta": [], "full": [], "maintain": [], "rescan": [],
                      "trace": [], "pool": []}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i in range(REPLAN_STEPS):
        Cw = C[i:i + I0]
        if profile:
            with torch.profiler.profile(activities=acts) as prof:
                plan = svc.replan(i, Cw, state, ig, 1.0, rng=draw)
                torch.cuda.synchronize()
            seen = _device_events(prof)
            times["trace"].append({
                "mode": svc.last_mode,
                "device_events": sum(c for _, c, _ in seen) or None,
                "device_ms": sum(t for _, _, t in seen) / 1e3 or None})
        else:
            t0 = time.perf_counter()
            plan = svc.replan(i, Cw, state, ig, 1.0, rng=draw)
            times[svc.last_mode].append(time.perf_counter() - t0)
        log.append((svc.last_mode, svc.last_reason, plan.tolist(),
                    svc.pool.tolist()))
        times["pool"].append(len(svc.pool))
        if gate:
            pool = svc.pool
            t0 = time.perf_counter()
            scores = score_candidates(pool, Cw, state, ig, rf, 1.0)
            w = select_candidate(pool, scores)
            times["rescan"].append(time.perf_counter() - t0)
            if not np.array_equal(plan, pool[w]):
                raise AssertionError(f"re-plan {i} ({svc.last_mode}) is not "
                                     f"the full rescan's schedule")
        if svc.last_mode == "delta":
            t0 = time.perf_counter()
            svc.maintain()
            if device != "cpu":
                torch.cuda.synchronize()
            times["maintain"].append(time.perf_counter() - t0)
        state, g, _ = SS.step(state, ig,
                              torch.as_tensor(C[i], device=device),
                              bool(plan[0]), s_max=8, collect="none")
        ig = int(g)
    stats = dict(svc.stats, invalidated=dict(svc.stats["invalidated"]))
    return log, stats, times


def _warm_ms(samples):
    """The least sample after the first (the first pays warm-up), ms."""
    return None if not samples else min(samples[1:] or samples) * 1e3


def run_replan_path(torch):
    """The replan phase: (a) the serving shape on the card, every answer a
    full rescan's bit for bit, timed, then traced answer by answer; (b)
    the small shape card against CPU; (c) the quickstart's FedSpace row
    routed through a service, against the unrouted card run. Returns the
    launch counts of (c)'s card runs."""
    from repro_torch.fl.api import Federation, SchedulerConfig
    from repro_torch.fl.replan import ReplanService
    from repro_torch.kernels import launch_counts
    from repro_torch.weights import params_to_numpy
    t_phase = time.perf_counter()
    rf = _search_forest()
    # (a)
    log, stats, times = _serve(torch, rf, REPLAN_SERVING, "cuda", gate=True)
    modes = [m for m, *_ in log]
    if "delta" not in modes:
        raise AssertionError("no re-plan took the delta path")
    traced_log, _, traced = _serve(torch, rf, REPLAN_SERVING, "cuda",
                                   profile=True)
    if [p for _, _, p, _ in traced_log] != [p for _, _, p, _ in log]:
        raise AssertionError("the traced re-plans differ from the timed")
    print("replan (a) serving", json.dumps({
        **REPLAN_SERVING, "steps": REPLAN_STEPS, "modes": modes,
        "stats": stats, "warm_delta_ms": _warm_ms(times["delta"]),
        "full_answer_ms": _warm_ms(times["full"]),
        "warm_full_rescan_ms": _warm_ms(times["rescan"]),
        "maintain_ms": _warm_ms(times["maintain"]),
        "delta_answers_ms": [t * 1e3 for t in times["delta"]],
        "rescans_ms": [t * 1e3 for t in times["rescan"]],
        "pool_rows": times["pool"], "traced": traced["trace"]}),
        flush=True)
    print(f"replan (a): {modes.count('delta')} of {REPLAN_STEPS} answers "
          f"delta, every answer the full rescan's schedule on the card",
          flush=True)

    # (b)
    sides = {d: _serve(torch, rf, REPLAN_SMALL, d, gate=True)[:2]
             for d in ("cuda", "cpu")}
    if sides["cuda"] != sides["cpu"]:
        raise AssertionError("replan (b): card and CPU services differ")
    print(f"replan (b) K {REPLAN_SMALL['K']} R {REPLAN_SMALL['R']} I0 "
          f"{REPLAN_SMALL['I0']}: pools, stats "
          f"{json.dumps(sides['cpu'][1])}, modes "
          f"{[m for m, *_ in sides['cpu'][0]]} and schedules equal, card "
          f"against CPU", flush=True)

    # (c) the quickstart's FedSpace row, unrouted and routed, on the card
    base = Federation.from_experiment(quickstart_experiment())
    fs = base.with_scheduler(SchedulerConfig(
        kind="fedspace", params=FEDSPACE_PARAMS, setup=FEDSPACE_SETUP))
    reg = fs.scheduler.regressor
    p0 = params_to_numpy(fs.adapter.init(torch.Generator().manual_seed(
        fs.experiment.seed)))
    counts = {}
    launch_counts.clear()
    with Replans() as plain_log:
        plain = fs.run(init_params=p0)
    torch.cuda.synchronize()
    _one_launch_per_aggregation(plain, dict(launch_counts))
    _add(counts, launch_counts)
    svc = ReplanService(reg, I0=FEDSPACE_PARAMS["I0"],
                        num_candidates=FEDSPACE_PARAMS["num_candidates"])
    routed_fed = fs.with_scheduler(SchedulerConfig(
        kind="fedspace", params={**FEDSPACE_PARAMS, "regressor": reg,
                                 "service": svc}))
    routed_log, inner = [], svc.replan

    def recording(*args, **kw):
        out = inner(*args, **kw)
        routed_log.append(out.tolist())
        return out
    svc.replan = recording
    launch_counts.clear()
    t0 = time.perf_counter()
    routed = routed_fed.run(init_params=p0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _one_launch_per_aggregation(routed, dict(launch_counts))
    _add(counts, launch_counts)
    _same_counters(routed, plain)
    if [p["schedule"].tolist() for p in plain_log.log] != routed_log:
        raise AssertionError("routed re-plans differ from the unrouted")
    if routed.accuracy != plain.accuracy or routed.val_loss != plain.val_loss:
        raise AssertionError("routed accuracies differ from the unrouted")
    print(f"replan (c) quickstart row routed (cuda): wall {wall:.3f} s, "
          f"{len(routed_log)} re-plans, schedules, counters and accuracies "
          f"equal to the unrouted card run; replan_stats "
          f"{json.dumps(routed.replan_stats)}", flush=True)
    print(f"replan: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"replan": counts}


# The cli phase: the verify recipe's fast FL smoke through the CLI, as a
# subprocess on the card. A wrapper runs the module as `python -m` does
# (`runpy`, the same argv) and prints the launch counts after it.
CLI_ARGS = ["--scheduler", "fedbuff", "--satellites", "16", "--days", "0.5",
            "--num-train", "800", "--M", "4"]
CLI_WRAPPER = ("import json, runpy; "
               "from repro_torch.kernels import launch_counts; "
               "runpy.run_module('repro_torch.launch.fl_train', "
               "run_name='__main__', alter_sys=True); "
               "print('launch counts', json.dumps(dict(launch_counts)))")


def run_cli_path(torch):
    """The cli phase: `python -m repro_torch.launch.fl_train` with
    CLI_ARGS on the card; its exit code, summary, JSONL and launches, and
    its integers against the same `build_experiment` run in-process on the
    CPU. Returns the subprocess's launch counts."""
    import os
    import tempfile
    from repro_torch.fl.api import Federation
    from repro_torch.launch import fl_train
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        jsonl = os.path.join(tmp, "m.jsonl")
        out = os.path.join(tmp, "out.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WRAPPER, *CLI_ARGS,
             "--metrics-jsonl", jsonl, "--out", out],
            capture_output=True, text=True, env=env, cwd=tmp, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
            raise AssertionError(f"the CLI exited {proc.returncode}")
        text = proc.stdout
        tail = text.rindex("launch counts ")
        counts = json.loads(text[tail + len("launch counts "):])
        summary = json.loads(text[text.index("\n{") + 1:tail])
        events = [json.loads(x) for x in open(jsonl)]
        with open(out) as f:
            saved = json.load(f)
    evals = [e for e in events if e["event"] == "eval"]
    if saved["summary"] != summary or not evals or \
            len(evals) != len(saved["eval_windows"]):
        raise AssertionError("the CLI's summary, --out and JSONL disagree")
    if not summary["global_updates"] or \
            counts.get("weighted_aggregate") != summary["global_updates"]:
        raise AssertionError(f"expected one agg launch per aggregation, got "
                             f"{counts} for {summary['global_updates']}")
    args = fl_train.parser().parse_args(CLI_ARGS + ["--device", "cpu"])
    cpu = Federation.from_experiment(fl_train.build_experiment(args),
                                     device="cpu").run().summary()
    for key in ("scheme", "global_updates", "aggregated_gradients",
                "idle_connections", "total_connections", "staleness_hist",
                "time_to_target_days"):
        if summary[key] != cpu[key]:
            raise AssertionError(f"cli {key}: card {summary[key]}, CPU "
                                 f"{cpu[key]}")
    print(f"cli (cuda): exit 0 in {wall:.3f} s, {len(evals)} JSONL evals, "
          f"summary {json.dumps(summary)}, launches {json.dumps(counts)}; "
          f"integers equal the CPU's in-process run", flush=True)
    return {"cli": counts}


# The zoo phase: examples/serve_decode.py's three reduced archs and
# qwen3-8b's, card against the port on the CPU (float32); qwen3-8b at full
# width in bfloat16 (configs/qwen3_8b.py: 36 layers, d_model 4096, 32/8
# heads, hd 128, d_ff 12,288, vocabulary 151,936; ~8.19 B parameters, 16.4
# GB) drawn on the card; mamba2-370m at full width in float32, cut in
# depth.
ZOO_REDUCED = ("gemma3-12b", "mamba2-370m", "mixtral-8x7b", "qwen3-8b")
ZOO_SERVE = (4, 8, 24, 64)          # batch, prompt, generated, cache
# float32 card against CPU through two layers: the kernels' and the
# products' order of sums against the plain versions' (the CPU tests hold
# the port to the reference at 2e-5; 1e-4 leaves the card's GEMMs room)
ZOO_F32_TOL = 1e-4
QWEN_PREFILL = (1, 2048)            # batch, sequence
QWEN_SERVE = (8, 512, 64, 2048)     # batch, prompt stepped, generated, cache
# bfloat16 against bfloat16 through qwen3-8b's 36 layers, relative L2 of
# the next-token logits: a rounding of one unit (2**-8 relative) where the
# two computations part in each layer's output, added up layer after layer
# in the worst case: 36 * 2**-8 = 0.1406. Stated before the first run.
QWEN_BF16_REL_TOL = 36 * 2 ** -8
# mamba2-370m at full width in float32, its depth cut from 48 SSD layers
# to 16: stepping 2,048 tokens through all 48 took 68 s of host-issued
# kernels (33 ms a token, measured on one H100), most of the phase's
# 120 s. Chunked prefill against the recurrence stepped token by token,
# relative L2 over every position's logits (2.1e-6 at 4 layers, S 512, on
# the CPU; 1.1e-5 at 48 layers, S 2048, on the card)
MAMBA_S = 2048
MAMBA_LAYERS = 16
MAMBA_REL_TOL = 1e-4
ZOO_TRACED_STEPS = 4


class PlainVersions:
    """Within the block, the zoo's RMSNorm and attention calls go to their
    kernels' plain versions (`kernels/*/ref.py`) on the card: the
    functions the models look up in the ops modules are swapped for the
    duration, by this script, not by a switch in the package."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as F
        from repro_torch.kernels.flash_attention.ref import attention_ref
        from repro_torch.kernels.rmsnorm import ops as R
        from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

        def bshd(q, k, v, *, causal=True, window=0):
            return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)
        self._saved = [(R, "rmsnorm", R.rmsnorm),
                       (F, "flash_attention", F.flash_attention),
                       (F, "flash_attention_bshd", F.flash_attention_bshd)]
        R.rmsnorm = rmsnorm_ref
        F.flash_attention = attention_ref
        F.flash_attention_bshd = bshd
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class RmsCalls:
    """Within the block, records the (G, R, D, dtype) of every RMSNorm
    kernel call on the card, both directions, by wrapping the kernel
    module's entry points that `kernels/rmsnorm/ops.py` calls. `unheld()`
    lists the configurations `check_rmsnorm` never held against the plain
    version (`RMS_SHAPES`)."""

    def __enter__(self):
        from repro_torch.kernels.rmsnorm import kernel as K
        self.seen, self._saved = set(), []
        for name in ("rmsnorm", "rmsnorm_bwd"):
            fn = getattr(K, name)

            def wrapped(x, scale, *args, _fn=fn, _name=name):
                if x.is_cuda:
                    self.seen.add((_name, *K._check(x, scale),
                                   str(x.dtype).split(".")[-1]))
                return _fn(x, scale, *args)
            self._saved.append((K, name, fn))
            setattr(K, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def unheld(self):
        held = {(*shape, dt) for shape, dt, off in RMS_SHAPES if off == 0}
        return sorted(c for c in self.seen if c[1:] not in held)


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1])


def _attends(cfg) -> bool:
    """Whether a layer kind of `cfg` calls attention."""
    return bool(set(cfg.layer_kinds) & {"global", "local", "enc", "cross"})


def _zoo_serve(torch, params, cfg, prompt, gen, cache, dtype,
               enc_frames=None):
    """examples/serve_decode.py's loop: the prompt stepped, `gen` tokens
    generated greedily (an encoder-decoder's state from `enc_frames`).
    Returns (tokens (B, gen), every step's logits, the state)."""
    from repro_torch.models import transformer as T
    state = T.init_decode_state(params, cfg, prompt.shape[0], cache, dtype,
                                enc_frames=enc_frames)
    logits = []
    with torch.inference_mode():
        for t in range(prompt.shape[1]):
            lg, state = T.decode_step(params, prompt[:, t:t + 1], state, cfg)
            logits.append(lg[:, 0])
        out = []
        for _ in range(gen - 1):
            tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None]
            out.append(tok)
            lg, state = T.decode_step(params, tok, state, cfg)
            logits.append(lg[:, 0])
        out.append(torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None])
    return torch.cat(out, dim=1), torch.stack(logits, dim=1), state


def _same_greedy(card, cpu, logits, tol, tag):
    """Greedy tokens equal; where a row parts, the CPU's top-2 gap at that
    step (`logits`: the CPU's, every step) is within twice the logits'
    tolerance (a near tie), and the row is not compared further. Returns
    the rows that parted."""
    parted = []
    p0 = logits.shape[1] - card.shape[1]
    for b in range(card.shape[0]):
        diff = (card[b] != cpu[b]).nonzero()
        if len(diff):
            t = int(diff[0])
            gap = float(_top2_gap(logits[b, p0 + t]))
            if gap >= 2 * tol:
                raise AssertionError(f"{tag}: row {b} parts at token {t} "
                                     f"with a top-2 gap of {gap}")
            parted.append((b, t, gap))
    return parted


def _zoo_reduced(torch, counts):
    """(a) Each reduced arch's serve loop on the card and on the CPU from
    the same parameters (drawn on the CPU): tokens, every step's logits
    and the final caches."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    B, P, G, C = ZOO_SERVE
    for arch in ZOO_REDUCED:
        cfg = get_config(arch).reduced()
        cpu = T.init_params(0, cfg, device="cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        prompt = torch.randint(0, cfg.vocab_size, (B, P),
                               generator=torch.Generator().manual_seed(1))
        launch_counts.clear()
        t0 = time.perf_counter()
        tok_k, lg_k, st_k = _zoo_serve(torch, card, cfg, prompt.cuda(), G, C,
                                       torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts.update(launch_counts)
        got = dict(launch_counts)
        tok_c, lg_c, st_c = _zoo_serve(torch, cpu, cfg, prompt, G, C,
                                       torch.float32)
        parted = _same_greedy(tok_k.cpu(), tok_c, lg_c, ZOO_F32_TOL, arch)
        rows = [b for b in range(B) if b not in {p[0] for p in parted}]
        lg_err = (lg_k.cpu()[rows] - lg_c[rows]).abs().max().item()
        cache_err = max((a.cpu() - b).abs().max().item() for a, b in zip(
            tree_leaves(st_k["caches"]), tree_leaves(st_c["caches"]))) \
            if not parted else None
        if lg_err > ZOO_F32_TOL or (cache_err or 0) > ZOO_F32_TOL:
            raise AssertionError(f"zoo (a) {arch}: logits {lg_err}, caches "
                                 f"{cache_err} beyond {ZOO_F32_TOL}")
        if not got.get("rmsnorm") or (_attends(cfg)
                                      != bool(got.get("flash_attention"))):
            raise AssertionError(f"zoo (a) {arch}: launches {got}")
        print("zoo (a)", json.dumps({
            "arch": cfg.name, "batch": B, "prompt": P, "generated": G,
            "cache": C, "tokens_equal": not parted, "parted": parted,
            "max_abs_err_logits": lg_err, "max_abs_err_caches": cache_err,
            "tol": ZOO_F32_TOL, "card_wall_s": wall,
            "index": st_k["index"], "launches": got}), flush=True)


def _trace_decode(torch, params, cfg, state, tok, steps):
    """`steps` decode steps traced: kernels, copy kernels and device
    microseconds a step, the wall of a step (host clock over the same
    steps untraced, ending in a synchronise) and the busy share. The
    steps write cache slots past the caller's index, which it never
    reads."""
    from repro_torch.models import transformer as T
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, state = T.decode_step(params, tok, state, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                _, state = T.decode_step(params, tok, state, cfg)
            torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        raise AssertionError("torch.profiler shows no device time")
    dev_us = sum(t for _, _, t in events) / steps
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "kernels_per_step": sum(c for _, c, _ in events) / steps,
            "copy_kernels_per_step": sum(c for n, c, _ in events
                                         if _is_copy_kernel(n)) / steps,
            "device_us_per_step": dev_us,
            "busy_share": dev_us / (wall_ms * 1e3),
            "device_us_per_step_by_name": {n[:100]: t / steps for n, _, t in
                                           sorted(events,
                                                  key=lambda e: -e[2])[:8]},
            "kernels_by_name": {n[:100]: c / steps for n, c, _ in sorted(
                events, key=lambda e: -e[1])[:12]}}


def _trace_decode_attention(torch, cfg, state, g):
    """One decode step's attention call as `attention_decode` makes it, on
    layer 0's cache after the serve loop: the query heads of a kv head as
    query rows, a (B, G, K, hd) view, against the cache's prefix (strided
    in B) through the (B, S, H, hd) entry point, whose wrapper copies the
    prefix on the tensor cores' route. Its kernels and copy kernels a
    call, device and host microseconds."""
    from repro_torch.kernels.flash_attention import ops as F
    ck, cv = (t[0] for t in state["caches"][0]["pos0"])
    B, _, K, hd = ck.shape
    n = min(state["index"] + 1, ck.shape[1])
    q = torch.randn(B, K, cfg.num_heads // K, hd, generator=g,
                    device="cuda").to(ck.dtype)
    with torch.inference_mode():
        host_us, dev_us, per_call, names, events, by_name = _host_and_device(
            lambda: F.flash_attention_bshd(q.transpose(1, 2), ck[:, :n],
                                           cv[:, :n], causal=False), 100)
    others = [x for x in names if not _is_copy_kernel(x)]
    return {"B": B, "K": K, "rows": q.shape[2], "Sk": n, "hd": hd,
            "kernels_per_call": per_call,
            "copy_kernels_per_call": per_call - len(others),
            "kernels_seen": [x[:100] for x in names], "device_us": dev_us,
            "device_us_by_kernel": {k[:100]: v for k, v in by_name.items()},
            "host_us": host_us,
            "profiled": f"{events} kernel events over 100 calls"}


def _zoo_qwen(torch, counts):
    """(b) qwen3-8b at full width in bfloat16, drawn on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(3)
    prefill = ST.make_prefill_step(cfg)
    B, S = QWEN_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    prefill(params, {"tokens": toks})               # warm
    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    counts.update(launch_counts)
    prefill_launches = dict(launch_counts)
    if prefill_launches.get("flash_attention_tc") != cfg.num_layers:
        raise AssertionError(f"zoo (b) prefill: {prefill_launches}, not "
                             f"{cfg.num_layers} tensor-core launches")
    with PlainVersions():
        want = prefill(params, {"tokens": toks})
    rel = _rel_l2(got, want)
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    gap = float(_top2_gap(want).min())
    if rel > QWEN_BF16_REL_TOL or not (same_top or gap < 2 * (
            got.float() - want.float()).abs().max().item()):
        raise AssertionError(f"zoo (b) prefill against the plain versions: "
                             f"rel L2 {rel} (tol {QWEN_BF16_REL_TOL}), top "
                             f"equal {same_top}, gap {gap}")
    print("zoo (b) prefill", json.dumps({
        "arch": cfg.name, "params": n_params, "dtype": cfg.param_dtype,
        "init_s": init_s, "batch": B, "seq": S, "ms": prefill_ms,
        "tokens_per_s": B * S / prefill_ms * 1e3,
        "rel_l2_vs_plain": rel, "max_abs_err_vs_plain":
        (got.float() - want.float()).abs().max().item(),
        "top1_equal": same_top, "plain_top2_gap": gap,
        "tol_rel_l2": QWEN_BF16_REL_TOL, "launches": prefill_launches}),
        flush=True)
    del got, want

    # the serve loop: the prompt stepped, tokens generated greedily
    B, P, G, C = QWEN_SERVE
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device="cuda")
    serve = ST.make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = T.init_decode_state(params, cfg, B, C, torch.bfloat16)
    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(P - 1):
        _, state = serve(params, state, prompt[:, t:t + 1])
    with torch.inference_mode():
        last, state = T.decode_step(params, prompt[:, P - 1:], state, cfg)
    tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(G - 1):
        tok, state = serve(params, state, tok)
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts.update(launch_counts)
    serve_launches = dict(launch_counts)
    steps = P + G - 1
    if serve_launches.get("flash_attention") != steps * cfg.num_layers:
        raise AssertionError(f"zoo (b) serve: {serve_launches}")
    peak = torch.cuda.max_memory_allocated()
    trace = _trace_decode(torch, params, cfg, state, tok, ZOO_TRACED_STEPS)
    call = _trace_decode_attention(torch, cfg, state, g)
    print("zoo decode attention call", json.dumps(call), flush=True)
    seen = call["kernels_seen"]
    if call["kernels_per_call"] != 3 or call["copy_kernels_per_call"] != 2 \
            or not any(TC_KERNEL in x for x in seen):
        raise AssertionError(f"the decode step's attention call ran {seen}, "
                             f"not the tensor-core kernel and the two "
                             f"prefix copies")
    # row 0 after the stepped prompt against a prefill of its 512 tokens
    launch_counts.clear()
    pre = prefill(params, {"tokens": prompt[:1]})
    counts.update(launch_counts)
    rel = _rel_l2(last[0, -1], pre[0])
    same_top = bool(last[0, -1].argmax() == pre[0].argmax())
    gap = float(_top2_gap(pre[0]))
    if rel > QWEN_BF16_REL_TOL or not (same_top or gap < 2 * (
            last[0, -1].float() - pre[0].float()).abs().max().item()):
        raise AssertionError(f"zoo (b) stepped prompt against prefill: rel "
                             f"L2 {rel}, top equal {same_top}, gap {gap}")
    step_ms = (t2 - t1) / (G - 1) * 1e3
    print("zoo (b) serve", json.dumps({
        "batch": B, "prompt_stepped": P, "generated": G, "cache": C,
        "prompt_ms_per_step": (t1 - t0) / P * 1e3, "ms_per_decode_step":
        step_ms, "tokens_per_s": B / step_ms * 1e3,
        "max_memory_allocated_gb": peak / 1e9, "index": state["index"],
        "launches": serve_launches,
        "launches_per_step": {k: v / steps for k, v in
                              serve_launches.items()},
        "rel_l2_row0_vs_prefill": rel, "top1_equal": same_top,
        "prefill_top2_gap": gap, "tol_rel_l2": QWEN_BF16_REL_TOL,
        "traced": trace}), flush=True)
    del params, state
    torch.cuda.empty_cache()


def _zoo_mamba(torch, counts):
    """(c) mamba2-370m at full width in float32, `MAMBA_LAYERS` deep: the
    chunked prefill of S 2048 against the same prompt stepped through
    `ssm_decode`."""
    import dataclasses
    from repro_torch.configs.base import StageSpec, get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(
        get_config("mamba2-370m"), param_dtype="float32",
        num_layers=MAMBA_LAYERS, stages=(StageSpec(("ssm",), MAMBA_LAYERS),))
    params = T.init_params(0, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, MAMBA_S), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(4))
    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        full, _ = T.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, stepped, state = _zoo_serve(torch, params, cfg, toks, 1, MAMBA_S,
                                   torch.float32)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / MAMBA_S * 1e3
    counts.update(launch_counts)
    got = dict(launch_counts)
    stepped = stepped[:, :MAMBA_S]
    rel = _rel_l2(stepped, full)
    if rel > MAMBA_REL_TOL or got.get("flash_attention"):
        raise AssertionError(f"zoo (c): rel L2 {rel} (tol {MAMBA_REL_TOL}),"
                             f" launches {got}")
    print("zoo (c)", json.dumps({
        "arch": cfg.name, "dtype": "float32", "layers": cfg.num_layers,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "seq": MAMBA_S,
        "prefill_ms": prefill_ms, "ms_per_decode_step": step_ms,
        "rel_l2_stepped_vs_prefill": rel, "max_abs_err":
        (stepped - full).abs().max().item(), "tol_rel_l2": MAMBA_REL_TOL,
        "index": state["index"], "launches": got}), flush=True)
    del params, full, stepped, state
    torch.cuda.empty_cache()


def run_zoo_path(torch):
    """The zoo phase: (a) the reduced archs card = CPU, (b) qwen3-8b at
    full width, (c) mamba2-370m at full width. Returns the card's launch
    counts over the three."""
    from collections import Counter
    counts = Counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays f32
    torch.cuda.empty_cache()
    seconds = {}
    for part, run in (("a", _zoo_reduced), ("b", _zoo_qwen),
                      ("c", _zoo_mamba)):
        t0 = time.perf_counter()
        run(torch, counts)
        seconds[part] = time.perf_counter() - t0
    print("zoo", json.dumps({"seconds": seconds, "total_s": sum(
        seconds.values()), "launches": dict(counts)}), flush=True)
    return {"zoo": dict(counts)}


# The families phase: the zoo's three last families, RecurrentGemma's
# RG-LRU (`recurrent` blocks with local attention), whisper's encoder and
# cross-attention (`enc`, `cross`) and phi-3-vision's image frontend
# (`vis_proj`, logits on the text positions). (a) Their reduced configs
# and recurrentgemma's hybrid (two recurrent layers and a local one),
# card against CPU in float32 within `ZOO_F32_TOL`: the prefill step and
# the serve loop (71 steps, past the reduced window of 64: the hybrid's
# ring wraps). (b) Each at full width in bf16 drawn on the card (the
# configs as registered: configs/recurrentgemma_9b.py, whisper_base.py,
# phi3_vision_4_2b.py), the image embeddings and frames random float32
# from a seed.
FAMILIES_REDUCED = ("recurrentgemma-9b", "recurrentgemma-9b/hybrid",
                    "whisper-base", "phi-3-vision-4.2b")
FAMILIES_SERVE = (4, 8, 64, 128)    # batch, prompt, generated, cache
# Per config: the prefill (batch, text tokens), the serve loop (batch,
# prompt stepped, generated, cache slots), the tolerance of the
# next-token logits against the plain versions and the launches a call,
# counted from the code (none of the three has qk-norm: 2 RMSNorm calls
# a layer, 3 a cross layer, and the final and encoder norms). The
# tolerances, stated before the first run as `QWEN_BF16_REL_TOL`: one
# bf16 unit (2**-8 relative) per layer that attends or recurs, added up
# layer after layer: recurrentgemma's 38, phi-3-vision's 32, whisper's 6
# encoder and 6 decoder layers.
FAMILIES = {
    "recurrentgemma-9b": dict(
        prefill=(1, 4096), serve=(8, 128, 32, 4096), tol=38 * 2 ** -8,
        forward={"flash_attention": 12, "flash_attention_tc256": 12,
                 "rmsnorm": 77},
        step={"flash_attention": 12, "flash_attention_tc256": 12,
              "rmsnorm": 77}),
    "phi-3-vision-4.2b": dict(
        prefill=(1, 1472), serve=(8, 128, 32, 2048), tol=32 * 2 ** -8,
        forward={"flash_attention": 32, "rmsnorm": 65},
        step={"flash_attention": 32, "rmsnorm": 65}),
    "whisper-base": dict(
        prefill=(8, 448), serve=(8, 32, 32, 448), tol=12 * 2 ** -8,
        forward={"flash_attention": 18, "rmsnorm": 32},
        encode={"flash_attention": 6, "rmsnorm": 13},
        step={"flash_attention": 12, "rmsnorm": 19}),
}
# recurrentgemma's timed-only step: index 4,095 (the ring's 2,048 slots
# all read) from caches and recurrent states filled with random values
RG_FULL_WINDOW = 4095


def _zoo_cfg(name):
    """A reduced config by name; "<arch>/hybrid" is recurrentgemma's
    registered pattern, two recurrent layers and a local one."""
    from repro_torch.configs.base import StageSpec, get_config
    arch, _, variant = name.partition("/")
    if variant == "hybrid":
        return get_config(arch).reduced(
            stages=(StageSpec(("recurrent", "recurrent", "local"), 1),),
            num_layers=3)
    return get_config(arch).reduced()


def _family_batch(torch, cfg, B, S, g, device):
    """tokens (B, S), and the family's inputs: image embeddings (B, N,
    1024) or encoder frames (B, encoder_seq, d_model), float32 normals."""
    from repro_torch.models.transformer import VISION_DIM
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                   device=device)}
    if cfg.frontend == "vision":
        out["image_embeds"] = torch.randn(B, cfg.num_image_tokens,
                                          VISION_DIM, generator=g,
                                          device=device)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                    generator=g, device=device)
    return out


def _families_reduced(torch, counts):
    """(a) Each family's reduced config on the card and on the CPU from
    the same parameters (drawn on the CPU) and inputs: the prefill step,
    then the serve loop's tokens, every step's logits and the final
    caches."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    B, P, G, C = FAMILIES_SERVE
    for name in FAMILIES_REDUCED:
        cfg = _zoo_cfg(name)
        cpu = T.init_params(0, cfg, device="cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        batch = _family_batch(torch, cfg, B, P,
                              torch.Generator().manual_seed(1), "cpu")
        frames = batch.get("frames")
        prefill = ST.make_prefill_step(cfg)
        launch_counts.clear()
        t0 = time.perf_counter()
        pre_k = prefill(card, {k: v.cuda() for k, v in batch.items()})
        tok_k, lg_k, st_k = _zoo_serve(
            torch, card, cfg, batch["tokens"].cuda(), G, C, torch.float32,
            None if frames is None else frames.cuda())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts.update(launch_counts)
        got = dict(launch_counts)
        pre_c = prefill(cpu, batch)
        tok_c, lg_c, st_c = _zoo_serve(torch, cpu, cfg, batch["tokens"], G,
                                       C, torch.float32, frames)
        parted = _same_greedy(tok_k.cpu(), tok_c, lg_c, ZOO_F32_TOL, name)
        rows = [b for b in range(B) if b not in {p[0] for p in parted}]
        pre_err = (pre_k.cpu() - pre_c).abs().max().item()
        lg_err = (lg_k.cpu()[rows] - lg_c[rows]).abs().max().item()
        cache_err = max((a.cpu() - b).abs().max().item()
                        for a, b in zip(tree_leaves(st_k["caches"]),
                                        tree_leaves(st_c["caches"]))) \
            if not parted else None
        if max(pre_err, lg_err, cache_err or 0) > ZOO_F32_TOL:
            raise AssertionError(f"families (a) {name}: prefill {pre_err}, "
                                 f"logits {lg_err}, caches {cache_err} "
                                 f"beyond {ZOO_F32_TOL}")
        if not got.get("rmsnorm") or (_attends(cfg)
                                      != bool(got.get("flash_attention"))):
            raise AssertionError(f"families (a) {name}: launches {got}")
        print("families (a)", json.dumps({
            "case": name, "kinds": sorted(set(cfg.layer_kinds)),
            "batch": B, "prompt": P, "generated": G, "cache": C,
            "window": cfg.window_size, "tokens_equal": not parted,
            "parted": parted, "max_abs_err_prefill": pre_err,
            "max_abs_err_logits": lg_err, "max_abs_err_caches": cache_err,
            "tol": ZOO_F32_TOL, "card_wall_s": wall,
            "index": st_k["index"], "launches": got}), flush=True)


def _expect_launches(tag, got, want, calls, tc, combines=0):
    """`got` holds `calls` times each count of `want`; with `tc`, every
    attention launch took the tensor cores, else none did; the hd-256
    tensor-core forward launched as often as `want` says (none where it
    is not named) and its combine `combines` times."""
    for name, n in want.items():
        if got.get(name, 0) != n * calls:
            raise AssertionError(f"{tag}: {got}, not {n} {name} a call over "
                                 f"{calls} calls")
    n_tc = got.get("flash_attention_tc", 0)
    if n_tc != (got.get("flash_attention", 0) if tc else 0):
        raise AssertionError(f"{tag}: {n_tc} tensor-core launches of "
                             f"{got.get('flash_attention')}")
    for name, n in (("flash_attention_tc256",
                     want.get("flash_attention_tc256", 0) * calls),
                    ("flash_attention_combine", combines)):
        if got.get(name, 0) != n:
            raise AssertionError(f"{tag}: {got}, not {n} {name} launches")


def _rg_combines(cfg, batch, indices):
    """The combines recurrentgemma's decode steps at cache `indices`
    launch: one a local layer where its call over min(index + 1, window)
    keys splits (`decode_splits`, 16 query rows a unit, batch x 1 units)."""
    from repro_torch.kernels.flash_attention import kernel as K
    sm = K._sm_count(0)
    layers = sum(kind == "local" for kind in cfg.layer_kinds)
    return layers * sum(
        K.decode_splits(batch * cfg.num_kv_heads,
                        min(i + 1, cfg.window_size), sm) > 1
        for i in indices)


def _check_close(tag, got, want, tol):
    """Next-token logits (B, V) against another computation's: relative
    L2 within `tol`, and each row's top token equal or parted within a
    near tie (`want`'s top-2 gap under twice the largest difference).
    Returns the numbers."""
    rel = _rel_l2(got, want)
    err = (got.float() - want.float()).abs().max().item()
    same = got.argmax(-1) == want.argmax(-1)
    gap = _top2_gap(want)
    if rel > tol or not bool((same | (gap < 2 * err)).all()):
        raise AssertionError(f"{tag}: rel L2 {rel} (tol {tol}), top equal "
                             f"{same.tolist()}, gaps {gap.tolist()}, max "
                             f"|diff| {err}")
    return {"rel_l2": rel, "max_abs_err": err, "top1_equal": bool(
        same.all()), "top2_gap_min": float(gap.min()), "tol_rel_l2": tol}


def _fill_random(torch, state, g):
    """Every cache and recurrent state of `state` normal random values,
    in place."""
    from repro_torch.tree import tree_leaves
    for t in tree_leaves(state["caches"]):
        t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _family_full(torch, arch, counts):
    """(b) One family at full width in bf16, drawn on the card: the
    prefill step timed, its launches asserted and its next-token logits
    against the plain versions'; the serve loop timed (whisper's state
    from its encoder's frames), its launches a step asserted, the greedy
    tokens and the next-token logits after it against the same inputs
    stepped with the plain versions, row 0's logits after the stepped
    prompt against a prefill of the prompt; four decode steps traced;
    for recurrentgemma a step at a full window, timed and traced. Every
    RMSNorm call of the timed runs at a shape `check_rmsnorm` held.
    Returns the launches by part."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    spec, cfg = FAMILIES[arch], get_config(arch)
    # hd 256 takes the hd-256 tensor-core forward ("tc256"), not "tc"
    tc = arch != "recurrentgemma-9b"
    launches = {}
    t0 = time.perf_counter()
    params = T.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(6)
    prefill, serve = ST.make_prefill_step(cfg), ST.make_serve_step(cfg)
    B, S = spec["prefill"]
    batch = _family_batch(torch, cfg, B, S, g, "cuda")
    prefill(params, batch)                          # warm
    with RmsCalls() as norms:
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        counts.update(launch_counts)
        launches["prefill"] = dict(launch_counts)
        _expect_launches(f"families (b) {arch} prefill", launches["prefill"],
                         spec["forward"], 1, tc)
        with PlainVersions():
            want = prefill(params, batch)
        pre = _check_close(f"families (b) {arch} prefill against the "
                           f"plain versions", got, want, spec["tol"])
        del got, want, batch

        # the serve loop: the prompt stepped, tokens generated greedily
        B, P, G, C = spec["serve"]
        inputs = _family_batch(torch, cfg, B, P, g, "cuda")
        prompt, frames = inputs["tokens"], inputs.get("frames")
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = T.init_decode_state(params, cfg, B, C, torch.bfloat16,
                                    enc_frames=frames)
        torch.cuda.synchronize()
        state_ms = (time.perf_counter() - t0) * 1e3
        counts.update(launch_counts)
        launches["decode_state"] = dict(launch_counts)
        _expect_launches(f"families (b) {arch} decode state",
                         launches["decode_state"], spec.get("encode", {}),
                         1, tc)
        launch_counts.clear()
        t0 = time.perf_counter()
        for t in range(P - 1):
            _, state = serve(params, state, prompt[:, t:t + 1])
        with torch.inference_mode():
            last, state = T.decode_step(params, prompt[:, P - 1:], state,
                                        cfg)
        tok = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(G - 1):
            tok, state = serve(params, state, tok)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps = P + G - 1
        counts.update(launch_counts)
        launches["serve"] = dict(launch_counts)
        _expect_launches(f"families (b) {arch} serve", launches["serve"],
                         spec["step"], steps, tc,
                         _rg_combines(cfg, B, range(steps))
                         if not tc else 0)
        peak = torch.cuda.max_memory_allocated()
    if norms.unheld():
        raise AssertionError(f"families (b) {arch}: RMSNorm calls at "
                             f"shapes check_rmsnorm never held: "
                             f"{norms.unheld()}")
    out = torch.cat(out, dim=1)
    with torch.inference_mode():
        nxt, _ = T.decode_step(params, tok, state, cfg)
    # the same inputs stepped with the plain versions: their greedy pick
    # at each generated position and their logits after the last
    with PlainVersions(), torch.inference_mode():
        st = T.init_decode_state(params, cfg, B, C, torch.bfloat16,
                                 enc_frames=frames)
        plain = []
        for x in torch.cat([prompt, out], dim=1).unbind(1):
            lg, st = T.decode_step(params, x[:, None], st, cfg)
            plain.append(lg[:, 0])
        plain = torch.stack(plain[P - 1:], dim=1)      # (B, G + 1, V)
        del st
    serve_plain = _check_close(f"families (b) {arch} serve against the "
                               f"plain versions", nxt[:, 0], plain[:, -1],
                               spec["tol"])
    parted = _same_greedy(out.cpu(), plain[:, :-1].argmax(-1).cpu(),
                          plain[:, :-1].cpu(), serve_plain["max_abs_err"],
                          f"families (b) {arch} greedy against the plain "
                          f"versions")
    # row 0 after the stepped prompt against a prefill of its P tokens
    one = {"tokens": prompt[:1]}
    if cfg.frontend == "vision":
        one["image_embeds"] = inputs["image_embeds"][:1, :0]
    if frames is not None:
        one["frames"] = frames[:1]
    stepped = _check_close(f"families (b) {arch} stepped prompt against "
                           f"prefill", last[:1, -1], prefill(params, one),
                           spec["tol"])
    del plain, last, nxt
    step_ms = (t2 - t1) / (G - 1) * 1e3
    trace = _trace_decode(torch, params, cfg, state, tok, ZOO_TRACED_STEPS)
    line = {
        "arch": arch, "params": n_params, "dtype": cfg.param_dtype,
        "init_s": init_s, "prefill": {
            "batch": spec["prefill"][0], "text_tokens": spec["prefill"][1],
            "positions": spec["prefill"][1] + (
                cfg.num_image_tokens if cfg.frontend == "vision" else 0),
            "frames": cfg.encoder_seq if frames is not None else None,
            "ms": prefill_ms, "vs_plain": pre},
        "serve": {"batch": B, "prompt_stepped": P, "generated": G,
                  "cache": C, "decode_state_ms": state_ms,
                  "prompt_ms_per_step": (t1 - t0) / P * 1e3,
                  "ms_per_decode_step": step_ms,
                  "tokens_per_s": B / step_ms * 1e3,
                  "max_memory_allocated_gb": peak / 1e9,
                  "vs_plain": serve_plain, "greedy_parted_vs_plain": parted,
                  "stepped_prompt_vs_prefill": stepped, "traced": trace},
        "launches": launches,
        "launches_per_step": {k: v / steps for k, v in
                              launches["serve"].items()},
        "rmsnorm_calls": sorted(norms.seen)}
    del state
    if arch == "recurrentgemma-9b":
        # a step at a full window, every ring slot read: timed only
        state = T.init_decode_state(params, cfg, B, C, torch.bfloat16)
        _fill_random(torch, state, g)
        state["index"] = RG_FULL_WINDOW
        launch_counts.clear()
        full = _trace_decode(torch, params, cfg, state, tok,
                             ZOO_TRACED_STEPS)
        counts.update(launch_counts)
        launches["full_window"] = dict(launch_counts)
        _expect_launches(f"families (b) {arch} full window",
                         launches["full_window"], spec["step"],
                         2 * ZOO_TRACED_STEPS, tc,
                         _rg_combines(cfg, B, range(
                             RG_FULL_WINDOW,
                             RG_FULL_WINDOW + 2 * ZOO_TRACED_STEPS)))
        line["full_window_step"] = {"index": RG_FULL_WINDOW,
                                    "keys_read": cfg.window_size, **full}
        del state
    print("families (b)", json.dumps(line), flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def run_families_path(torch):
    """The families phase: (a) the reduced families card = CPU, (b) each
    family at full width. Returns the card's launch counts over both, and
    (b)'s by arch."""
    from collections import Counter
    counts = Counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays f32
    torch.cuda.empty_cache()
    seconds, by_arch = {}, {}
    t0 = time.perf_counter()
    _families_reduced(torch, counts)
    seconds["a"] = time.perf_counter() - t0
    for arch in FAMILIES:
        t0 = time.perf_counter()
        before = Counter(counts)
        _family_full(torch, arch, counts)
        by_arch[arch] = dict(counts - before)
        seconds[arch] = time.perf_counter() - t0
    print("families", json.dumps({"seconds": seconds, "total_s": sum(
        seconds.values()), "launches": dict(counts),
        "launches_by_arch": by_arch}), flush=True)
    return {"families": dict(counts)}, by_arch


TRAIN_REDUCED = ("qwen3-8b", "qwen3-8b-swa", "gemma3-12b", "h2o-danube-1.8b",
                 "minitron-4b", "mamba2-370m", "mixtral-8x7b",
                 "qwen3-moe-30b-a3b") + FAMILIES_REDUCED
# batch 4 in 2 microbatches; 80 tokens, past the reduced window (64) and
# over four SSD chunks; two steps, as tests/test_torch_zoo_train.py
TRAIN_SHAPE = (4, 80)
TRAIN_STEPS = 2
TRAIN_LR = 3e-4
# float32 card against CPU after each step, both from the same state (the
# CPU tests' tolerances for the port against the reference, stated before
# the first run; that run let the two run on freely, and gemma3's m and v
# after step 2 parted by 7.5e-5 of a leaf's largest entry: its step-2
# gradients were taken at params the first step had moved apart where
# it was ill-conditioned): loss and grad_norm relative; AdamW's m
# and v to a share of each leaf's largest entry; every param within one
# step (lr) and all but a share of them within 1% of lr. An AdamW step is
# lr * g / (|g| + eps) at step 1: an entry whose gradient is within its
# error of 0, or near eps, steps by up to lr either way.
TRAIN_LOSS_TOL = 1e-5
TRAIN_MOMENT_TOL = 5e-5
TRAIN_PARAM_ATOL = 0.01 * TRAIN_LR
TRAIN_ILL_SHARE = 1e-4
# The zoo's configs at full width for training, cut in depth for memory:
# bf16 params and grads, a float32 microbatch sum and AdamW's float32 m
# and v are 12 bytes a parameter (plus the sum's 4). qwen3-8b: the whole
# model's 8.19 B need 98 GB of the card's 80; 8 of its 36 layers are
# 2.79 B, ~45-55 GB. recurrentgemma-9b: 6 of its 38 layers (two repeats
# of (recurrent, recurrent, local)) are 3.41 B (its 256,000 x 4,096
# embedding and untied LM head 2.10 B of them): 16 bytes a parameter
# make 54.6 GB, with S 4096's activations and float32 logits ~65-72 GB.
QWEN_TRAIN_LAYERS = 8
QWEN_TRAIN = (2, 2048)               # batch, sequence
RG_TRAIN_LAYERS = 6
RG_TRAIN = (2, 4096)                 # batch, sequence: a microbatch's
                                     # attention is FLASH_RG
TRAIN_FULL_TIMED = 3                 # steps timed after the checks' two
TRAIN_FULL_LR = 3e-4
DIGEST_CHUNK = 1 << 26               # elements a chunk of `_digest`
PART_B = dict(steps=24, batch=4, seq=64, lr=3e-4)   # examples/
                                     # satellite_fl_train.py's Part B


def _same_train_state(tag, card, cpu, lr):
    """Card against CPU after one step (`card`, `cpu`: (loss, grad_norm,
    params, AdamW state), the card's on the host). Returns the errors
    seen."""
    from repro_torch.tree import tree_leaves
    (cl, cg, c_params, c_opt), (hl, hg, h_params, h_opt) = card, cpu
    err = {"loss": abs(cl - hl) / abs(hl), "grad_norm": abs(cg - hg) / hg,
           "moments": 0.0, "params": 0.0}
    for a, b in zip(tree_leaves([c_opt["m"], c_opt["v"]]),
                    tree_leaves([h_opt["m"], h_opt["v"]])):
        err["moments"] = max(err["moments"], ((a - b).abs().max()
                                              / b.abs().max()).item())
    beyond = total = 0
    for a, b in zip(tree_leaves(c_params), tree_leaves(h_params)):
        d = (a.float() - b.float()).abs()
        err["params"] = max(err["params"], d.max().item())
        beyond += int((d > TRAIN_PARAM_ATOL).sum())
        total += d.numel()
    err["params_beyond_share"] = beyond / total
    if (err["loss"] > TRAIN_LOSS_TOL or err["grad_norm"] > TRAIN_LOSS_TOL
            or err["moments"] > TRAIN_MOMENT_TOL or err["params"] > lr
            or beyond > TRAIN_ILL_SHARE * total
            or int(c_opt["step"]) != int(h_opt["step"])):
        raise AssertionError(f"{tag}: card against CPU {err}")
    return err


def _train_reduced(torch, counts):
    """(a) Each served arch's reduced config in float32: train steps of
    two microbatches on the card and on the CPU, each from the same
    state (the first from parameters drawn on the CPU; before each later
    step the CPU's params and AdamW state are copied to the card) and
    the same `synthetic_lm_batch` batch, held to each other after each
    step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    B, S = TRAIN_SHAPE
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    for arch in TRAIN_REDUCED:
        cfg = _zoo_cfg(arch)
        step = ST.make_train_step(cfg, num_micro=2, lr=TRAIN_LR)
        cpu = T.init_params(0, cfg, device="cpu")
        cpu_opt = adamw_init(cpu)
        card = tree_map(lambda t: t.cuda(), cpu)
        card_opt = adamw_init(card)
        launch_counts.clear()
        errs, losses, wall, cpu_wall = [], [], 0.0, 0.0
        for s in range(TRAIN_STEPS):
            if s:
                with torch.no_grad():
                    for a, b in zip(tree_leaves([card, card_opt]),
                                    tree_leaves([cpu, cpu_opt])):
                        a.copy_(b)
            t0 = time.perf_counter()
            card, card_opt, m = step(card, card_opt, synthetic_lm_batch(
                cfg, shape, s, device="cuda"))
            got = (m["loss"].item(), m["grad_norm"].item(),
                   *tree_map(lambda t: t.cpu(), (card, card_opt)))
            t1 = time.perf_counter()
            cpu, cpu_opt, m = step(cpu, cpu_opt, synthetic_lm_batch(
                cfg, shape, s, device="cpu"))
            want = (m["loss"].item(), m["grad_norm"].item(), cpu, cpu_opt)
            cpu_wall += time.perf_counter() - t1
            wall += t1 - t0
            errs.append(_same_train_state(f"train (a) {arch} step {s}",
                                          got, want, TRAIN_LR))
            losses.append((got[0], want[0], got[1]))
        counts.update(launch_counts)
        launches = dict(launch_counts)
        if not launches.get("rmsnorm_bwd") or _attends(cfg) != bool(
                launches.get("flash_attention_bwd")):
            raise AssertionError(f"train (a) {arch}: launches {launches}")
        print("train (a)", json.dumps({
            "arch": cfg.name, "case": arch, "batch": B, "seq": S,
            "num_micro": 2,
            "steps": TRAIN_STEPS, "lr": TRAIN_LR,
            "loss": [x[0] for x in losses], "cpu_loss": [x[1] for x in
                                                         losses],
            "grad_norm": [x[2] for x in losses], "errors": errs,
            "tol": {"loss_grad_norm_rel": TRAIN_LOSS_TOL,
                    "moments_of_leaf_max": TRAIN_MOMENT_TOL,
                    "params": TRAIN_LR, "params_1pct_lr_share":
                    TRAIN_ILL_SHARE},
            "card_wall_s": wall, "cpu_wall_s": cpu_wall,
            "launches": launches}), flush=True)


def _digest(torch, t):
    """Two int64 sums of a tensor's bits (plain, and weighted by position;
    both wrap): equal for equal bits."""
    flat = t.reshape(-1).view(torch.int32 if t.element_size() == 4
                              else torch.int16)
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), DIGEST_CHUNK):
        c = flat[i:i + DIGEST_CHUNK].long()
        w = torch.arange(i + 1, i + 1 + c.numel(), device=t.device)
        out += torch.stack([c.sum(), (c * w).sum()])
    return out


def _matmul_params(cfg, params):
    """Parameters that enter a matmul: the stages' weight matrices and
    the LM head (the tied table where there is none); not the embedding's
    gather, not the norms' scales."""
    from repro_torch.tree import tree_leaves
    n = sum(t.numel() for t in tree_leaves(params["stages"]) if t.dim() >= 3)
    return n + params["emb"].get("lm_head", params["emb"]["embed"]).numel()


def _train_trace(torch, step, params, opt, batches):
    """Two train steps: one run as the step's two halves
    (`step.loss_and_grad`, then `step.update`: clipping and AdamW) with
    CUDA events between them, for each half's time; then one traced
    whole, whose kernel launches (the exact `launch_counts`) must be the
    halves'. Kernels, copy kernels, device us and the 10 slowest kernels
    come from the whole step's trace (the profiler dropped events of a
    step split into two windows: 2,887 of 3,018 kernels in one H100
    run)."""
    from repro_torch.kernels import launch_counts
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    launch_counts.clear()
    ev[0].record()
    _, grads = step.loss_and_grad(params, batches[0])
    ev[1].record()
    step.update(params, opt, grads)
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    halves = dict(launch_counts)
    half_ms = {"grad": ev[0].elapsed_time(ev[1]),
               "optimizer": ev[1].elapsed_time(ev[2])}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launch_counts.clear()
    with torch.profiler.profile(activities=acts) as prof:
        step(params, opt, batches[1])
        torch.cuda.synchronize()
    if dict(launch_counts) != halves:
        raise AssertionError(f"the whole step launched {dict(launch_counts)}"
                             f", its two halves {halves}")
    whole = _device_events(prof)
    if not whole:
        raise AssertionError("torch.profiler shows no device time")
    dev_us = sum(t for _, _, t in whole)
    share = lambda *keys: sum(t for n, _, t in whole  # noqa: E731
                              if any(k in n for k in keys)) / dev_us
    return {
        "kernels": sum(c for _, c, _ in whole),
        "copy_kernels": sum(c for n, c, _ in whole if _is_copy_kernel(n)),
        "device_us": dev_us,
        "launches_each_way": halves,
        "ms_by_half": half_ms,
        "optimizer_share": half_ms["optimizer"] / sum(half_ms.values()),
        # every route's attention kernels (the CUDA cores' too, which an
        # earlier checkout's step may take)
        "attention_bwd_share": share("flash_bwd", "flash_delta",
                                     "flash_dkdv", "flash_dq"),
        "attention_fwd_share": share("flash_fwd", "flash_combine"),
        "rmsnorm_share": share("rmsnorm"),
        "slowest_kernels_us": {n[:100]: t for n, _, t in sorted(
            whole, key=lambda e: -e[2])[:10]}}


def train_cut(arch, layers, stages):
    """`arch`'s registered config at full width, cut in depth to `layers`
    layers in `stages` (`StageSpec`s), and the full config."""
    import dataclasses
    from repro_torch.configs.base import get_config
    full = get_config(arch)
    return dataclasses.replace(full, num_layers=layers,
                               stages=stages), full


def rg_train_config():
    """recurrentgemma-9b cut to `RG_TRAIN_LAYERS` of its 38 layers: two
    repeats of its pattern (recurrent, recurrent, local), so two local
    layers; and the full config."""
    from repro_torch.configs.base import StageSpec
    return train_cut("recurrentgemma-9b", RG_TRAIN_LAYERS,
                     (StageSpec(("recurrent", "recurrent", "local"),
                                RG_TRAIN_LAYERS // 3),))


def rg_train_flops(cfg, params):
    """Model FLOPs of one train step of `rg_train_config` at `RG_TRAIN`: 6
    N tokens over the matmul params, plus 3 times the local layers'
    attention forward (4 hd operations a visible pair and head)."""
    B, S = RG_TRAIN
    local = cfg.num_layers // 3
    return (6 * _matmul_params(cfg, params) * B * S
            + 3 * 4 * cfg.resolved_head_dim * cfg.num_heads * B
            * cost.visible_pairs(S, S, True, cfg.window_size) * local)


def use_port(src):
    """Import the port from the directory `src` (another checkout's
    `src`) from here on: it goes first on the path, and the port's modules
    already imported (this script imports `repro_torch.kernels.cost`) are
    dropped."""
    sys.path.insert(0, str(Path(src).resolve()))
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]


def train_setup(torch, cfg, batch_seq, lr=TRAIN_FULL_LR, steps=0):
    """A train step of `cfg` at B x S (`batch_seq`) in `default_num_micro`
    microbatches, remat on, its params drawn on the card from seed 0,
    AdamW's state and `steps` `synthetic_lm_batch` batches: (step, nm,
    params, opt, batches)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    B, S = batch_seq
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    nm = ST.default_num_micro(cfg, shape)
    params = T.init_params(0, cfg, device="cuda")
    return (ST.make_train_step(cfg, num_micro=nm, lr=lr), nm, params,
            adamw_init(params),
            [synthetic_lm_batch(cfg, shape, s) for s in range(steps)])


def time_train_steps(torch, step, params, opt, batches, timed):
    """`timed` steps on `batches[1:]` after none, each ended by a
    synchronise, then two traced (`_train_trace`): (ms a step, the
    median; each step's ms; losses; peak memory in bytes; the trace)."""
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for s in range(1, timed + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[s])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    trace = _train_trace(torch, step, params, opt, batches[timed + 1:])
    step_s = sorted(walls)[len(walls) // 2]
    trace["busy_share"] = trace["device_us"] / (step_s * 1e6)
    return step_s * 1e3, [w * 1e3 for w in walls], losses, peak, trace


def _train_full(torch, counts, tag, cfg, cut, batch_seq, want, flops_fn):
    """A config at full width in bf16, cut in depth (`cut` says how and
    why), B x S (`batch_seq`) in `default_num_micro` microbatches, remat
    on: one step's loss and gradients against the plain versions' (within
    L 2^-8 and 2 L 2^-8 relative), two steps from copies of one state bit
    for bit (the state's copy on the host: one copy on the card would not
    fit beside AdamW's), the launches of a step (`want(nm)`), every
    RMSNorm call at a held shape, then timed and traced steps; `ms`, tokens
    a second, `mfu` (`flops_fn(cfg, params)`, the model FLOPs of a step,
    over the bf16 peak) and peak memory printed on the `tag` line."""
    from repro_torch.kernels import launch_counts
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    L = cfg.num_layers
    B, S = batch_seq
    step, nm, params, opt, batches = train_setup(
        torch, cfg, batch_seq, steps=TRAIN_FULL_TIMED + 3)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # bf16 against bf16 on the card, kernels against their plain versions
    # (stated before the first run, as QWEN_BF16_REL_TOL): a rounding of
    # one unit (2**-8 relative) where the two part in each layer's output,
    # added up layer after layer: the loss through the L layers' forward,
    # each gradient through the forward and the backward's L layers again
    loss_tol, grad_tol = L * 2 ** -8, 2 * L * 2 ** -8

    # one step's loss and gradients, kernels against plain versions (the
    # kernels' float32 gradients wait on the host: beside the plain
    # version's on the card, recurrentgemma-9b's did not fit)
    loss_k, grads_k = step.loss_and_grad(params, batches[0])
    grads_k = [t.cpu() for t in tree_leaves(grads_k)]
    torch.cuda.empty_cache()
    with PlainVersions():
        loss_p, grads_p = step.loss_and_grad(params, batches[0])
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = [_rel_l2(a.to(b.device), b)
                for a, b in zip(grads_k, tree_leaves(grads_p))]
    if loss_rel > loss_tol or max(grad_rel) > grad_tol:
        raise AssertionError(f"{tag} against the plain versions: loss "
                             f"{loss_rel}, gradients {grad_rel}")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # two steps from copies of one state: the first is the main path's
    # step whose launches are counted
    start = [t.cpu() for t in tree_leaves(params)]
    launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with RmsCalls() as norms:
        params, opt, m_a = step(params, opt, batches[0])
        torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts.update(launch_counts)
    launches = dict(launch_counts)
    if norms.unheld():
        raise AssertionError(f"{tag}: RMSNorm calls never held against "
                             f"the plain version: {norms.unheld()}")
    want = want(nm)
    if any(launches.get(k) != v for k, v in want.items()):
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    a_metrics = (m_a["loss"].clone(), m_a["grad_norm"].clone())
    a_digest = [_digest(torch, t) for t in tree_leaves([params, opt])]
    del opt
    torch.cuda.empty_cache()
    with torch.no_grad():
        for t, h in zip(tree_leaves(params), start):
            t.copy_(h)
    del start
    opt = adamw_init(params)
    params, opt, m_b = step(params, opt, batches[0])
    same = (torch.equal(a_metrics[0], m_b["loss"])
            and torch.equal(a_metrics[1], m_b["grad_norm"])
            and all(torch.equal(d, _digest(torch, t)) for d, t in zip(
                a_digest, tree_leaves([params, opt]))))
    if not same:
        raise AssertionError(f"{tag}: two steps from copies of one state "
                             f"differ")
    torch.cuda.empty_cache()

    # timed steps, then one traced
    ms, ms_steps, losses, peak, trace = time_train_steps(
        torch, step, params, opt, batches, TRAIN_FULL_TIMED)
    tokens = B * S
    flops = flops_fn(cfg, params)
    print(tag, json.dumps({
        "arch": cfg.name, "layers": L, "cut": cut, "params": n_params,
        "dtype": cfg.param_dtype, "batch": B, "seq": S, "num_micro": nm,
        "remat": True, "lr": TRAIN_FULL_LR,
        "loss_rel_vs_plain": loss_rel, "grad_rel_l2_vs_plain_max":
        max(grad_rel), "grad_rel_l2_vs_plain": grad_rel,
        "tol": {"loss_rel": loss_tol, "grad_rel_l2": grad_tol},
        "bit_for_bit_from_one_state": same, "first_step_ms": first_ms,
        "ms_per_step": ms, "ms_steps": ms_steps,
        "tokens_per_s": tokens / ms * 1e3, "model_flops_per_step": flops,
        "mfu": flops / (ms / 1e3) / cost.BF16_TC_FLOP_PER_S,
        "max_memory_allocated_gb": peak / 1e9,
        "loss": [m_b["loss"].item()] + losses,
        "launches": launches, "launches_want": want,
        "rmsnorm_calls": sorted(norms.seen), "traced": trace}),
        flush=True)
    del params, opt, batches
    torch.cuda.empty_cache()


def _train_qwen(torch, counts):
    """(b) qwen3-8b at full width, cut to `QWEN_TRAIN_LAYERS` layers, B 2
    x S 2048 (`_train_full`)."""
    from repro_torch.configs.base import StageSpec
    L = QWEN_TRAIN_LAYERS
    cfg, full = train_cut("qwen3-8b", L, (StageSpec(("global",), L),))
    B, S = QWEN_TRAIN

    # per microbatch: every layer's attention forward, again in the
    # backward's recompute (remat), and its backward; four norms a layer
    # (block, q, k, ffn) forward and recomputed, the final norm once,
    # and each norm's backward once
    def want(nm):
        return {"flash_attention_tc": 2 * nm * L,
                "flash_attention_bwd_tc": nm * L,
                "rmsnorm": nm * (4 * L + 1) + nm * 4 * L,
                "rmsnorm_bwd": nm * (4 * L + 1)}
    def flops(cfg, params):     # 6 N tokens plus causal attention
        return (6 * _matmul_params(cfg, params) * B * S
                + 3 * 2 * B * S * S * cfg.num_heads * cfg.resolved_head_dim
                * L)
    _train_full(torch, counts, "train (b)", cfg,
                f"{L} of {full.num_layers} layers, for memory: AdamW over "
                f"the whole model needs ~98 GB", QWEN_TRAIN, want, flops)


def _train_rg(torch, counts):
    """(d) recurrentgemma-9b at full width, cut to `RG_TRAIN_LAYERS`
    layers (two local), B 2 x S 4096 (`_train_full`): each microbatch's
    local-layer attention is `FLASH_RG`, forward and backward on the hd-256
    tensor-core kernels."""
    cfg, full = rg_train_config()
    L, local = cfg.num_layers, cfg.num_layers // 3

    # per microbatch: each local layer's attention forward, again in the
    # backward's recompute, and its backward; two norms a block (the
    # recurrent block's or the attention's, and the FFN's) forward and
    # recomputed, the final norm once, and each norm's backward once
    def want(nm):
        return {"flash_attention_tc256": 2 * nm * local,
                "flash_attention_bwd_tc256": nm * local,
                "flash_attention_bwd": nm * local,
                "rmsnorm": nm * (2 * L + 1) + nm * 2 * L,
                "rmsnorm_bwd": nm * (2 * L + 1)}
    _train_full(torch, counts, "train (d)", cfg,
                f"{L} of {full.num_layers} layers, two repeats of (recurrent"
                f", recurrent, local), for memory: AdamW over the whole "
                f"model needs ~150 GB", RG_TRAIN, want, rg_train_flops)


class StepTimes:
    """While entered, each call of a train step that
    `launch.steps.make_train_step` makes is timed on the host clock up to
    a synchronise (`ms`, in call order): the steps alone, without the
    set-up around them (the mesh, the params' draw, the first
    collective's communicator)."""

    def __init__(self, torch):
        self.torch, self.ms = torch, []

    def __enter__(self):
        from repro_torch.launch import steps as ST
        self.ST, self.make = ST, ST.make_train_step

        def make(*args, **kw):
            step = self.make(*args, **kw)

            def timed(*a):
                t0 = time.perf_counter()
                out = step(*a)
                self.torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return timed
        ST.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.ST.make_train_step = self.make


def part_b(torch):
    """Part B once (`launch.train.train`, `PART_B`) on the default group
    the caller started, if any: (loss history, wall s, each step's ms)."""
    from repro_torch.launch.train import train
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StepTimes(torch) as steps:
        hist = train("mamba2-370m", reduced=False, log_every=4, **PART_B)
        torch.cuda.synchronize()
    return hist, time.perf_counter() - t0, steps.ms


def _train_part_b(torch, counts):
    """(c) Part B of examples/satellite_fl_train.py as the reference runs
    it: mamba2-370m at full config (48 layers, bf16) through
    `launch.train.train`, on the host mesh of the world-1 NCCL group
    `main` started; the loss must fall, and every RMSNorm call's
    configuration must be one `check_rmsnorm` held (`RmsCalls`). Timed
    whole (wall over steps, as since PR 26) and a step at a time."""
    from repro_torch.kernels import launch_counts
    launch_counts.clear()
    with RmsCalls() as norms:
        hist, wall, ms_steps = part_b(torch)
    counts.update(launch_counts)
    got = dict(launch_counts)
    if not hist[-1] < hist[0] or got.get("flash_attention") \
            or not got.get("rmsnorm_bwd") or norms.unheld():
        raise AssertionError(f"train (c): loss {hist[0]} -> {hist[-1]}, "
                             f"launches {got}, RMSNorm calls never held "
                             f"against the plain version {norms.unheld()}")
    print("train (c)", json.dumps({
        "arch": "mamba2-370m", "config": "full (48 layers, bf16)", **PART_B,
        "loss_history": hist, "ms_per_step": wall / PART_B["steps"] * 1e3,
        "wall_s": wall, "ms_per_step_steps_alone": statistics.median(
            ms_steps), "ms_steps": ms_steps, "launches": got,
        "rmsnorm_calls": sorted(norms.seen)}), flush=True)


def run_train_path(torch, t_start):
    """The train phase: (a) the reduced archs card = CPU, (b) qwen3-8b at
    full width cut in depth, (c) Part B, (d) recurrentgemma-9b at full
    width cut in depth. Returns the card's launch counts over the four."""
    from collections import Counter
    counts = Counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays f32
    torch.cuda.empty_cache()
    seconds = {}
    for part, run in (("a", _train_reduced), ("b", _train_qwen),
                      ("c", _train_part_b), ("d", _train_rg)):
        t0 = time.perf_counter()
        run(torch, counts)
        seconds[part] = time.perf_counter() - t0
    print("train", json.dumps({
        "seconds": seconds, "total_s": sum(seconds.values()),
        "script_s": time.perf_counter() - t_start,
        "launches": dict(counts)}), flush=True)
    return {"train": dict(counts)}


# The launch phase: `repro_torch.launch.steps`' eq.-4 agg step, its
# bf16-product form and the FL round, and a dry run (`launch.dryrun`).
# (a) float32, card against CPU from the same params, M by arch in turn;
# the FL round at M 3, 2 local SGD steps, B 2 x S 32. Tolerances of the
# CPU tests for the port against the reference (tests/
# test_torch_launch_tools.py): the agg step AGG_TOL (the same products in
# another order); the bf16 product one bf16 ulp (2^-7) of the weighted
# sum; the FL round 1e-4 of the largest entry of the aggregated update
# beside two float32 roundings of a param (2^-22 of it).
LAUNCH_M = (4, 5, 6)
LAUNCH_ROUND_ARCHS = ("qwen3-8b", "mamba2-370m")
LAUNCH_ROUND = (3, 2, 2, 32)           # M, local steps, batch, sequence
LAUNCH_ROUND_SCALE_TOL = 1e-4
LAUNCH_ROUND_RTOL = 2 ** -22
# (b), (c): the kernel's bf16 output against its plain version's: float32
# sums in another order round to bf16 at most one ulp apart, 2^-7 of a
# value (stated before the first run)
AGG_BF16_RTOL = 2 ** -7
AGG_WINDOW = 1 << 20                   # columns a window held (b)
AGG_CHUNK = 1 << 30                    # columns a chunk where the whole
                                       # does not fit (the plain version's
                                       # float32 copy, `addmv`'s output)
LAUNCH_AGG = (("whisper-base", 96, False), ("qwen3-8b", 2, True))
PEAK_SLACK = 1 << 30                   # bytes over params + updates + out
ROUND_ARCH, ROUND_SHAPE = "mamba2-370m", "flround_m16"
DRYRUN_ARGS = ("--arch", "qwen3-8b", "--shape", "train_4k")


def start_dryrun():
    """(d)'s dry run, started in a fresh process with no card visible: it
    runs on the host's CPU beside the build, and `_finish_dryrun` waits
    for it before the first timed phase."""
    import os
    out = ROOT / "build" / "dryrun_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    log = open(ROOT / "build" / "dryrun_torch.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch."
                             "dryrun", *DRYRUN_ARGS, "--out", str(out)],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    proc.out, proc.log, proc.t0 = out, log, time.perf_counter()
    return proc


def _flat_on_card(torch, tree, like=None, lead=()):
    """`tree` on the card as views of one buffer a dtype (`flat_tree`),
    laid out as `like`'s rows where it is an (M, ...) update stack."""
    from repro_torch.kernels.agg.ops import flat_tree
    from repro_torch.tree import tree_map
    card = flat_tree(tree if like is None else like, lead=lead,
                     device="cuda")
    tree_map(lambda d, s: d.copy_(s), card, tree)
    return card


def _launch_reduced(torch, counts):
    """(a) The agg step and the bf16-product agg step for every served
    arch's reduced config (the train phase's list), and the FL round for
    reduced qwen3-8b and mamba2-370m, float32, on the card and on the CPU
    from the same params, updates, batches and staleness."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    g = torch.Generator().manual_seed(0)
    errs = {}
    for i, arch in enumerate(TRAIN_REDUCED):
        cfg = _zoo_cfg(arch)
        m = LAUNCH_M[i % len(LAUNCH_M)]
        cpu = T.init_params(0, cfg, device="cpu")
        upd = tree_map(lambda p: 0.01 * torch.randn((m,) + p.shape,
                                                    generator=g), cpu)
        stal = torch.randint(0, 9, (m,), generator=g, dtype=torch.int32)
        card = _flat_on_card(torch, cpu)
        card_u = _flat_on_card(torch, upd, cpu, (m,))
        for name, step, launches in (("agg", ST.make_agg_step(cfg), 1),
                                     ("agg_opt", ST.make_agg_step_opt(cfg),
                                      0)):
            want = step(cpu, upd, stal)
            launch_counts.clear()
            got = step(card, card_u, stal.cuda())
            torch.cuda.synchronize()
            counts.update(launch_counts)
            if launch_counts["weighted_aggregate"] != launches:
                raise AssertionError(f"launch (a) {arch} {name}: "
                                     f"{dict(launch_counts)}")
            err = 0.0
            for a, b, u in zip(tree_leaves(got), tree_leaves(want),
                               tree_leaves(upd)):
                a = a.cpu()
                if name == "agg":
                    rtol, atol = AGG_TOL, AGG_TOL
                else:
                    rtol, atol = 2 ** -7, 2 ** -7 * u.abs().sum(0).max()
                err = max(err, (a - b).abs().max().item())
                if not torch.allclose(a, b, rtol=rtol, atol=float(atol)):
                    raise AssertionError(f"launch (a) {arch} {name}: card "
                                         f"against CPU {err}")
            errs[f"{arch} {name} M {m}"] = err
    M, steps, B, S = LAUNCH_ROUND
    for arch in LAUNCH_ROUND_ARCHS:
        cfg = _zoo_cfg(arch)
        cpu = T.init_params(0, cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (M, steps, B, S + 1),
                             generator=g)
        batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        stal = torch.randint(0, 9, (M,), generator=g, dtype=torch.int32)
        step = ST.make_fl_round_step(cfg, local_steps=steps)
        want = step(cpu, batches, stal)
        launch_counts.clear()
        got = step(_flat_on_card(torch, cpu),
                   {k: v.cuda() for k, v in batches.items()}, stal.cuda())
        torch.cuda.synchronize()
        counts.update(launch_counts)
        if launch_counts["weighted_aggregate"] != 1 or not launch_counts[
                "rmsnorm_bwd"]:
            raise AssertionError(f"launch (a) {arch} round: "
                                 f"{dict(launch_counts)}")
        err = 0.0
        for a, b, p in zip(tree_leaves(got), tree_leaves(want),
                           tree_leaves(cpu)):
            a = a.cpu()
            atol = LAUNCH_ROUND_SCALE_TOL * (b - p).abs().max().item()
            err = max(err, (a - b).abs().max().item())
            if not torch.allclose(a, b, rtol=LAUNCH_ROUND_RTOL, atol=atol):
                raise AssertionError(f"launch (a) {arch} round: card "
                                     f"against CPU {err}")
        errs[f"{arch} round M {M}"] = err
    print("launch (a)", json.dumps({
        "archs": list(TRAIN_REDUCED), "round": dict(zip(
            ("m", "local_steps", "batch", "seq"), LAUNCH_ROUND)),
        "max_abs_err": errs}), flush=True)


def _agg_yardsticks(torch, p, u, w, chunked, library):
    """The plain version's ms and one PyTorch call's (`addmv` in bf16, the
    weights rounded to bf16; None without `library`, and where the rows
    lie 2^31 or more elements apart, which cuBLAS's leading dimension
    cannot hold) on the same inputs, whole or, where the whole does not
    fit, over column chunks of `AGG_CHUNK` timed together."""
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    n = p.shape[0]
    cuts = [slice(a, a + AGG_CHUNK) for a in range(0, n, AGG_CHUNK)] \
        if chunked else [slice(0, n)]
    w16 = w.to(p.dtype)

    def plain():
        for c in cuts:
            weighted_aggregate_ref(p[c], u[:, c], w)

    def addmv():
        for c in cuts:
            torch.addmv(p[c], u[:, c].t(), w16)
    library = library and u.stride(0) < 2 ** 31 - 1
    return (_time_ms(plain, 2), _time_ms(addmv, 5) if library else None)


def _launch_agg_full(torch, arch, m, chunked, counts):
    """(b) The agg step at full width in bf16, random from a seed: params
    and M updates as views of one buffer each (`flat_tree`; no copy of
    either would fit beside them at qwen3-8b), one launch a step, its
    output against the plain version over column windows (the first
    element, the middle, the last, and around 2^30, 2^31 and 2^32), the
    peak memory within `PEAK_SLACK` of params + updates + output, then
    the step, the kernel, its plain version and `addmv` timed."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.aggregation import aggregation_weights
    from repro_torch.kernels import cost, launch_counts
    from repro_torch.kernels.agg import kernel as K
    from repro_torch.kernels.agg.ops import FlatLayout, flat_tree
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(1)
    params = flat_tree(T.init_params(0, cfg, device="meta"), device="cuda")
    upd = flat_tree(params, lead=(m,))
    for t in tree_leaves(params):
        t.normal_(0, 0.02, generator=g)
    for t in tree_leaves(upd):
        t.normal_(0, 0.01, generator=g)
    stal = torch.randint(0, 9, (m,), generator=g, device="cuda",
                         dtype=torch.int32)
    leaves = tree_leaves(params)
    layout = FlatLayout.of(leaves)
    p_flat = layout.buffer_of(leaves)
    u_flat = layout.buffer_of(tree_leaves(upd), lead=1)
    n = layout.size
    step = ST.make_agg_step(cfg)
    launch_counts.clear()
    t0 = time.perf_counter()
    new = step(params, upd, stal)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    got = dict(launch_counts)
    counts.update(launch_counts)
    if got != {"weighted_aggregate": 1} or p_flat is None or u_flat is None:
        raise AssertionError(f"launch (b) {arch}: launches {got}, params "
                             f"and updates in place: {p_flat is not None}, "
                             f"{u_flat is not None}")
    out = layout.buffer_of(tree_leaves(new))
    w = aggregation_weights(stal)
    half = AGG_WINDOW // 2
    starts = sorted({0, n // 2 - half, n - AGG_WINDOW} | {
        c - half for c in (1 << 30, 1 << 31, 1 << 32) if c + half <= n})
    err = 0.0
    for a in starts:
        win = slice(a, a + AGG_WINDOW)
        want = weighted_aggregate_ref(p_flat[win], u_flat[:, win], w).float()
        have = out[win].float()
        err = max(err, (have - want).abs().max().item())
        if not torch.allclose(have, want, rtol=AGG_BF16_RTOL, atol=1e-6):
            raise AssertionError(f"launch (b) {arch}: the kernel against "
                                 f"its plain version at columns {a}: {err}")
    peak = torch.cuda.max_memory_allocated() - base
    resident = (m + 2) * n * p_flat.element_size()
    if peak > resident + PEAK_SLACK:
        raise AssertionError(f"launch (b) {arch}: peak {peak} bytes over "
                             f"params + updates + output {resident}")
    del new, out
    iters = 5
    step_ms = _time_ms(lambda: step(params, upd, stal), iters)
    kernel_ms = _time_ms(lambda: K.weighted_aggregate(p_flat, u_flat, w),
                         iters)
    plain_ms, lib_ms = _agg_yardsticks(torch, p_flat, u_flat, w, chunked,
                                       True)
    bound, by = cost.bound(*cost.agg(m, n, 2, 2), cost.FP32_FLOP_PER_S)
    row = {"arch": arch, "m": m, "n": n, "params_total": sum(
        t.numel() for t in leaves), "params": "bfloat16",
        "updates": "bfloat16", "design": K.design_for(n, u_flat.stride(0)
                                                      * 2),
        "launches_per_step": 1, "windows": starts, "max_abs_err": err,
        "tol_rel": AGG_BF16_RTOL, "first_step_ms": first_ms,
        "step_ms": step_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "plain_chunked": chunked, "library_ms": lib_ms,
        "library": "torch.addmv in bf16" if lib_ms is not None else
        "none: cuBLAS takes no row stride of 2^31 elements or more",
        "bound_ms": bound,
        "bound_by": by, "bound_share": bound / kernel_ms,
        "peak_bytes": peak, "resident_bytes": resident}
    print("launch (b)", json.dumps(row), flush=True)
    del params, upd, p_flat, u_flat, leaves
    torch.cuda.empty_cache()
    return row


def _launch_round(torch, counts):
    """(c) The FL round of `ROUND_SHAPE` on `ROUND_ARCH`'s full config, no
    cut (M 16, 4 local SGD steps, B 8 x S 512, bf16, random from a seed):
    the round's wall, the clients' and the aggregation's shares, the
    launches counted from the code, the peak memory (no copy of the
    update stack), every RMSNorm call at a held shape, and the
    aggregation's output against the plain version on the same rows; then
    the kernel and its plain version timed on them."""
    from repro_torch.configs.base import INPUT_SHAPES, get_config
    from repro_torch.kernels import cost, launch_counts
    from repro_torch.kernels.agg import kernel as K
    from repro_torch.kernels.agg import ops
    from repro_torch.kernels.agg.ref import weighted_aggregate_ref
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg, shape = get_config(ROUND_ARCH), INPUT_SHAPES[ROUND_SHAPE]
    M, S, steps, B = shape.global_batch, shape.seq_len, 4, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = _flat_on_card(torch, T.init_params(0, cfg))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (M, steps, B, S + 1),
                         generator=g, device="cuda")
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    stal = torch.randint(0, 9, (M,), generator=g, device="cuda",
                         dtype=torch.int32)
    step = ST.make_fl_round_step(cfg, local_steps=steps)
    seen, agg_s = [], []
    real_flat, real_apply = ops.aggregate_flat, ST.apply_aggregation

    def spy(p, u, w, rows=None):
        out = real_flat(p, u, w, rows)
        seen.append((p, u, w, out))
        return out

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_apply(*a, **k)
        torch.cuda.synchronize()
        agg_s.append(time.perf_counter() - t)
        return out
    ops.aggregate_flat, ST.apply_aggregation = spy, timed
    try:
        with RmsCalls() as norms:
            launch_counts.clear()
            t0 = time.perf_counter()
            step(params, batches, stal)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ops.aggregate_flat, ST.apply_aggregation = real_flat, real_apply
    got = dict(launch_counts)
    counts.update(launch_counts)
    peak = torch.cuda.max_memory_allocated() - base
    L, calls = cfg.num_layers, M * steps
    dtypes = len({t.dtype for t in tree_leaves(params)})
    # a forward's norms: two a layer (the block's, the SSD's out_norm) and
    # the final one; remat recomputes the layers' in the backward
    want = {"rmsnorm": calls * (2 * L + 1 + 2 * L),
            "rmsnorm_bwd": calls * (2 * L + 1),
            "weighted_aggregate": dtypes}
    ((p, u, w, out),) = [c for c in seen if c[0].dtype == torch.bfloat16]
    upd_bytes = sum(c[1].numel() * c[1].element_size() for c in seen)
    if got != want or norms.unheld() or peak > 2 * upd_bytes:
        raise AssertionError(f"launch (c): launches {got}, not {want}; "
                             f"RMSNorm calls never held {norms.unheld()}; "
                             f"peak {peak} bytes, the update stack "
                             f"{upd_bytes}")
    ref = weighted_aggregate_ref(p, u, w).float()
    err = (out.float() - ref).abs().max().item()
    if not torch.allclose(out.float(), ref, rtol=AGG_BF16_RTOL, atol=1e-6):
        raise AssertionError(f"launch (c): the aggregation against its plain "
                             f"version {err}")
    del ref
    n = p.shape[0]
    kernel_ms = _time_ms(lambda: K.weighted_aggregate(p, u, w), 5)
    plain_ms, _ = _agg_yardsticks(torch, p, u, w, False, False)
    bound, by = cost.bound(*cost.agg(M, n, 4, 2), cost.FP32_FLOP_PER_S)
    row = {"arch": ROUND_ARCH, "shape": ROUND_SHAPE, "m": M,
           "local_steps": steps, "batch": B, "seq": S,
           "wall_s": wall, "aggregation_s": sum(agg_s),
           "aggregation_share": sum(agg_s) / wall,
           "clients_share": 1 - sum(agg_s) / wall,
           "s_per_sgd_step": (wall - sum(agg_s)) / calls,
           "launches": got, "launches_counted": want,
           "rmsnorm_calls": sorted(norms.seen), "peak_bytes": peak,
           "update_stack_bytes": upd_bytes, "n": n, "params": "bfloat16",
           "updates": "float32",
           "design": K.design_for(n, u.stride(0) * 4), "max_abs_err": err,
           "tol_rel": AGG_BF16_RTOL, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
           "bound_by": by, "bound_share": bound / kernel_ms}
    print("launch (c)", json.dumps(row), flush=True)
    del seen, p, u, w, out, params, batches, toks
    torch.cuda.empty_cache()
    return row


def _finish_dryrun(proc):
    """(d) The dry run's record: it must say ok; its terms printed."""
    rc = proc.wait(timeout=600)
    proc.log.close()
    wall = time.perf_counter() - proc.t0
    log = (ROOT / "build" / "dryrun_torch.log").read_text()
    if rc:
        raise AssertionError(f"launch (d): the dry run exited {rc}: "
                             f"{log[-2000:]}")
    (rec,) = json.loads(proc.out.read_text())
    if rec["status"] != "ok":
        raise AssertionError(f"launch (d): {rec}")
    keys = ("arch", "shape", "mesh", "chips", "status", "time_s",
            "params_total", "params_active", "model_flops", "hlo_flops",
            "hlo_bytes", "useful_flops_ratio", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant_term", "memory", "ops_counted",
            "kernel_calls")
    print("launch (d)", json.dumps({**{k: rec[k] for k in keys},
                                    "process_wall_s": wall}), flush=True)
    return rec


def run_launch_path(torch):
    """The launch phase: (a) card = CPU on reduced configs, (b) the agg
    step at full width, (c) the FL round at full width ((d), the dry run,
    ran beside the build). Returns ({"launch": the card's launch counts},
    its aggregation rows)."""
    from collections import Counter
    counts = Counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays f32
    seconds, rows = {}, {}
    t0 = time.perf_counter()
    _launch_reduced(torch, counts)
    seconds["a"] = time.perf_counter() - t0
    for arch, m, chunked in LAUNCH_AGG:
        t0 = time.perf_counter()
        rows[f"{arch} M {m}"] = _launch_agg_full(torch, arch, m, chunked,
                                                 counts)
        seconds[f"b {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows[f"{ROUND_ARCH} {ROUND_SHAPE}"] = _launch_round(torch, counts)
    seconds["c"] = time.perf_counter() - t0
    print("launch", json.dumps({"seconds": seconds,
                                "total_s": sum(seconds.values()),
                                "launches": dict(counts)}), flush=True)
    return {"launch": dict(counts)}, rows


# ptxas's report of a kernel, from its mangled name - <length><name>I<template
# arguments>E - to its registers: the tensor-core kernels (hd, and for dk/dv
# and dq whether P and dS are split), the hd-256 forward (warps, stages)
# and its combine (hd), and the short-sequence kernels (type, hd)
PTXAS_ENTRY = (r"Compiling entry function '\w*?\d({})I{}E.*?(\d+) bytes "
               r"spill stores, (\d+) bytes spill loads.*?Used (\d+) "
               r"registers")
PTXAS_KERNELS = {"tc": (r"flash_\w+?_tc_\w*?kernel",
                        r"Li(\d+)E(?:Lb(\d)E)?"),
                 "short": (r"flash_(?:fwd|bwd)_short_kernel",
                           r"(f|13__nv_bfloat16)Li(\d+)E"),
                 "tc256": (r"flash_(?:fwd_tc256|combine)_kernel",
                           r"Li(\d+)E(?:Li(\d+)E)?"),
                 "bwd256": (r"flash_bwd_tc256_(?:delta|dkdv|dq|merge)_kernel",
                            r"L([bi])(\d+)E"),
                 "agg": (r"agg_(?:register|ring)_kernel",
                         r"((?:f|13__nv_bfloat16)(?:f|13__nv_bfloat16|S1_))"
                         r"(?:Li(\d)E)?")}
SHORT_INSTANCES = 2 * 2 * 6    # directions x types x head dims
TC256_INSTANCES = 3            # forward at (1 warp, 3 stages), (4, 2); combine
BWD256_INSTANCES = 6           # dk/dv and dq, P and dS in 1 or 2 parts;
                               # delta and merge at hd 256
AGG_INSTANCES = 4 * 3          # type pairs x (register 4- and 1-wide, ring)


def _ptxas(log: str, kind: str):
    """The registers and spills of the tensor-core kernels (forward;
    backward delta, dk/dv and dq), of the short-sequence kernels (both
    directions, every type and hd) or of the aggregation's (both designs,
    every type pair), one line per instantiation, from ptxas's report;
    fails on a spill, and, for the short and the aggregation kernels,
    unless every instantiation is reported (a reused library has no
    report, and nothing is checked)."""
    import re
    found = re.findall(PTXAS_ENTRY.format(*PTXAS_KERNELS[kind]), log,
                       re.S)
    for kernel, a, b, stores, loads, regs in found:
        if kind == "tc":
            what = f"{kernel} hd {a}" + (f" split {b}" if b else "")
        elif kind == "tc256":
            what = (f"{kernel} warps {a} stages {b}" if b
                    else f"{kernel} hd {a}")
        elif kind == "bwd256":
            what = f"{kernel} " + (f"split {b}" if a == "b" else f"hd {b}")
        elif kind == "short":
            what = f"{kernel} {'bf16' if 'bfloat16' in a else 'f32'} hd {b}"
        else:
            what = f"{kernel} <{a}>" + (f" E {b}" if b else "")
        print(f"{what}: {regs} registers, {stores} bytes spill stores, "
              f"{loads} bytes spill loads", flush=True)
        if int(stores) or int(loads):
            raise AssertionError(f"{what} spills")
    want = {"short": SHORT_INSTANCES, "agg": AGG_INSTANCES,
            "tc256": TC256_INSTANCES, "bwd256": BWD256_INSTANCES}.get(kind)
    if want and "Compiling entry function" in log and len(found) != want:
        raise AssertionError(f"ptxas reported {len(found)} {kind} "
                             f"kernels, not {want}")


# The zoo tp phase (`zoo tp` lines): tensor parallelism over the model axis
# (`models/layers.py::TensorParallel` through the train, prefill and serve
# steps of `launch/steps.py` on a live mesh) on the one card, after the
# world-1 NCCL group has ended: `ZOO_TP_RANKS` processes spawned over a
# gloo group on a `FileStore`, each on the same card, the mesh
# `ZOO_TP_MESH` over (data, model). NCCL refuses two ranks on one device;
# gloo carries the CUDA tensors' all-reduces and all-gathers through host
# memory, so the phase's times are not those of tensor parallelism over
# NVLink. (a) qwen3-8b at full width cut to `ZOO_TP_LAYERS` of its 36
# layers (bf16 params and gradients, float32 microbatch sums and AdamW
# moments: ~16 bytes a parameter, 2.0 B parameters, ~32 GB for `mesh=None`
# run first and freed, ~16 GB a rank; the cut keeps both ranks' peaks on
# the card and the phase near 90 s); (b) qwen3-moe-30b-a3b cut to
# `ZOO_TP_MOE_LAYERS` of its 48 layers (3.1 B parameters), its 128
# experts 64 a rank, in float32: in bf16 the partition's other rounding
# flips top-8 choices at near-ties and moves an expert stack's gradient
# as far as the kernels' own numerics do (`scripts/zoo_tp_phase.py
# --controls`), so only float32 holds the gradients leaf by leaf. Each rank's named gradient leaves go to the parent
# through files in a temporary directory (~1.3 GB a rank for (a), ~2.9 GB
# for (b)).
ZOO_TP_RANKS = 2
ZOO_TP_MESH = (1, 2)
ZOO_TP_LAYERS = 4
ZOO_TP_MOE_LAYERS = 4
ZOO_TP_TRAIN = (2, 2048)             # batch, sequence: 2 microbatches
ZOO_TP_PREFILL = (1, 2048)           # batch, sequence
ZOO_TP_SERVE = (8, 8, 64)            # batch, greedy steps, cache slots
ZOO_TP_TIMEOUT = 600                 # seconds for the spawned world
ZOO_TP_MOE_DTYPE = "float32"
# float32 against `mesh=None`: the loss as the train phase's card against
# CPU (`TRAIN_LOSS_TOL`), a gradient leaf's relative L2 error as the CPU
# tests' gradient tolerance (1e-4)
ZOO_TP_F32_GRAD_TOL = 1e-4


class FlashCalls:
    """Within the block, counts the zoo's attention kernel calls on the
    card by (direction, B, H, K, Sq, Sk, hd, causal, window, dtype), by
    wrapping the kernel module's (B, S, H, hd) entry points that
    `kernels/flash_attention/ops.py` calls (the transformer's layout)."""

    def __enter__(self):
        from collections import Counter
        from repro_torch.kernels.flash_attention import kernel as K
        self.seen, self._saved = Counter(), []
        for name, tag in (("flash_attention_bshd", "fwd"),
                          ("flash_attention_bshd_bwd", "bwd")):
            fn = getattr(K, name)

            def wrapped(q, k, v, *args, _fn=fn, _tag=tag, causal=True,
                        window=0):
                if q.is_cuda:
                    self.seen[(_tag, *K._sizes(q, k, True), q.shape[-1],
                               causal, window,
                               str(q.dtype).split(".")[-1])] += 1
                return _fn(q, k, v, *args, causal=causal, window=window)
            self._saved.append((K, name, fn))
            setattr(K, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class MoeRoutes:
    """Within the block, keeps the expert ids (G, Tg, k) of every MoE
    dispatch in call order (a remat's recomputation too), by wrapping
    `models/moe.py::_dispatch_combine`, which `moe_apply` calls."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe as M
        self.ids, self._fn = [], M._dispatch_combine

        def wrapped(xg, gate_vals, expert_idx, *args, **kw):
            self.ids.append(expert_idx.detach().to("cpu", torch.int16))
            return self._fn(xg, gate_vals, expert_idx, *args, **kw)
        M._dispatch_combine = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as M
        M._dispatch_combine = self._fn


def _flips(got, want):
    """(tokens whose expert set differs, tokens routed) over two runs'
    `MoeRoutes.ids`, call by call."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} MoE dispatches, not {len(want)}")
    differ = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for a, b in zip(got, want))
    return differ, sum(a[..., 0].numel() for a in want)


def _tp_named(tree, moe: bool):
    """The named leaves of a params-shaped tree (params, gradients or
    specs): the embedding, the LM head, and the first and last layer's
    wq, wk, wo and w_down (and a MoE layer's router and w_gate), a
    layer's leaf taken at its index on the stage's repeat axis."""
    out = {"embed": (tree["emb"]["embed"], None),
           "lm_head": (tree["emb"]["lm_head"], None)}
    block = tree["stages"][0]["pos0"]
    ffn = block["ffn"]["moe" if moe else "mlp"]
    for i, tag in ((0, "first"), (-1, "last")):
        for key in ("wq", "wk", "wo"):
            out[f"{tag}.{key}"] = (block["attn"][key], i)
        for key in (("router", "w_gate", "w_down") if moe else ("w_down",)):
            out[f"{tag}.{key}"] = (ffn[key], i)
    return out


def _tp_program(torch, cfg, mesh, part, card=""):
    """One program of the phase on `mesh` (None: one device, the
    reference), from seed 0's params drawn on the card, a rank's pieces
    of them on a live mesh (`sharding.shard_params`). Part "a": the
    prefill step at `ZOO_TP_PREFILL` (a warm call, then one timed), the
    greedy serve loop of `ZOO_TP_SERVE` from seeded tokens (on one device
    `transformer.decode_step` and `torch.argmax`, each step's top-2 logit
    gap kept), then the train step at `ZOO_TP_TRAIN`: its loss and
    gradients, then one whole step timed. Part "b": the loss and gradients
    alone, and the global gradient norm. Returns the results on the host:
    the named gradient leaves (`_tp_named`; a rank's pieces), the MoE
    routes (`MoeRoutes`), the launches, collectives and kernel shapes of
    the mesh's steps."""
    from collections import Counter
    from repro_torch import sharding as Sh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import mesh as MM
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves
    moe = bool(cfg.num_experts)
    out = {"launches": {}, "collectives": {}}
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 stays f32
    params = T.init_params(0, cfg, device="cuda")
    if mesh is not None:
        params = Sh.shard_params(params, cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(3)
    flash, rms, unheld = Counter(), set(), set()

    def counted(key, fn):
        launch_counts.clear()
        MM.collective_counts.clear()
        with FlashCalls() as f, RmsCalls() as r:
            got = fn()
            torch.cuda.synchronize()
        flash.update(f.seen)
        rms.update(r.seen)
        unheld.update(r.unheld())
        out["launches"][key] = dict(launch_counts)
        out["collectives"][key] = dict(MM.collective_counts)
        return got

    if part == "a":
        B, S = ZOO_TP_PREFILL
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device="cuda")
        prefill = ST.make_prefill_step(cfg, mesh=mesh)
        prefill(params, {"tokens": toks})                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = counted("prefill", lambda: prefill(params, {"tokens": toks}))
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill"] = logits.float().cpu()
        B, steps, C = ZOO_TP_SERVE
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                            device="cuda", dtype=torch.int32)
        if mesh is None:
            state = T.init_decode_state(params, cfg, B, C,
                                        getattr(torch, cfg.param_dtype))
            toks, gaps = [], []
            with torch.inference_mode():
                for _ in range(steps):
                    lg, state = T.decode_step(params, tok, state, cfg)
                    gaps.append(_top2_gap(lg[:, -1]))
                    tok = torch.argmax(lg[:, -1], dim=-1).to(
                        torch.int32)[:, None]
                    toks.append(tok)
            out["serve_gaps"] = torch.stack(gaps, dim=1).cpu()
        else:
            serve = ST.make_serve_step(cfg, mesh)
            state = ST.init_serve_state(params, cfg, B, C, mesh)

            def loop():
                nonlocal tok, state
                toks = []
                for _ in range(steps):
                    tok, state = serve(params, state, tok)
                    toks.append(tok)
                return toks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = counted("serve", loop)
            out["serve_ms_per_step"] = (time.perf_counter() - t0) / steps \
                * 1e3
            out["cache_kv_heads"] = tree_leaves(state["caches"])[0].shape[-2]
        out["serve"] = torch.cat(toks, dim=1).cpu()
        del state

    B, S = ZOO_TP_TRAIN
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    nm = ST.default_num_micro(cfg, shape)
    step = ST.build(cfg, shape, mesh, num_micro=nm)[0]
    batch = synthetic_lm_batch(cfg, shape, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with MoeRoutes() as routes:
        loss, grads = counted("loss_and_grad",
                              lambda: step.loss_and_grad(params, batch))
    out["routes"] = routes.ids
    out["loss_and_grad_ms"] = (time.perf_counter() - t0) * 1e3
    out["num_micro"] = nm
    out["loss"] = loss.item()
    if mesh is None:
        out["grad_norm_lg"] = global_norm(grads).item()
    else:
        meta = T.init_params(0, cfg, device="meta")
        cut = [Sh.model_sharded(s) for s in tree_leaves(
            Sh.param_specs(meta, cfg, mesh), is_leaf=Sh.is_spec)]
        out["grad_norm_lg"] = global_norm(
            grads, sharded=cut, group=mesh.get_group("model")).item()
    out["grads"] = {k: (x if i is None else x[i]).cpu()
                    for k, (x, i) in _tp_named(grads, moe).items()}
    del grads
    if part == "a":
        opt = ST.init_opt_state(params, cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = counted("train", lambda: step(params, opt, batch))
        out["train_ms"] = (time.perf_counter() - t0) * 1e3
        out["train_loss"], out["grad_norm"] = (m["loss"].item(),
                                               m["grad_norm"].item())
        del opt
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["flash_calls"] = sorted([list(k), n] for k, n in flash.items())
    out["rms_calls"] = sorted(list(c) for c in rms)
    out["rms_unheld"] = sorted(list(c) for c in unheld)
    del params, batch
    torch.cuda.empty_cache()
    return out


def tp_config(arch):
    """The phase's configs: `arch` at full width cut in depth (qwen3-moe
    in float32, `ZOO_TP_MOE_DTYPE`), and the full config."""
    import dataclasses
    from repro_torch.configs.base import StageSpec
    if arch != "qwen3-moe-30b-a3b":
        return train_cut(arch, ZOO_TP_LAYERS,
                         (StageSpec(("global",), ZOO_TP_LAYERS),))
    L = ZOO_TP_MOE_LAYERS
    cfg, full = train_cut(arch, L, (StageSpec(("global",), L),))
    return dataclasses.replace(cfg, param_dtype=ZOO_TP_MOE_DTYPE), full


def _tp_rank(rank, world, out_dir):
    """One rank of the phase's spawned world: the gloo group, the mesh
    over the one card, parts (a) and (b), each rank's results saved to
    ``{out_dir}/rank{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(out_dir) / "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(ZOO_TP_MESH),
                          mesh_dim_names=("data", "model"))
        out = {part: _tp_program(torch, tp_config(arch)[0], mesh, part)
               for part, arch in (("a", "qwen3-8b"),
                                  ("b", "qwen3-moe-30b-a3b"))}
        from repro_torch import sharding as Sh
        out["coord"] = Sh.coordinate(mesh)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_rel_l2(torch, pieces, want, spec, sizes):
    """The relative L2 error of a leaf whose ranks hold `pieces`
    [(coords, piece)] against the whole `want`: the squared errors of
    each rank's piece against its piece of `want` (`sharding.piece`),
    summed once a piece (ranks holding the same piece count once)."""
    from repro_torch import sharding as Sh
    err, seen = 0.0, set()
    for coords, got in pieces:
        ref = Sh.piece(want, spec, sizes, coords)
        key = tuple(Sh.shard_range(want.shape[d], e, sizes, coords)
                    for d, e in enumerate(spec) if e is not None)
        if key in seen:
            continue
        seen.add(key)
        err += float((got.float() - ref.float()).square().sum())
    return (err / float(want.float().square().sum())) ** 0.5


def run_zoo_tp_path(torch, card):
    """Tensor parallelism over the model axis on one card: (a) qwen3-8b and
    (b) qwen3-moe-30b-a3b cut in depth (`tp_config`), each first on one
    device (`mesh=None`, `_tp_program`) and freed, then on a spawned world
    of `ZOO_TP_RANKS` gloo ranks over the mesh `ZOO_TP_MESH` (`_tp_rank`):
    the loss, the gradient norm and the named gradient leaves within the
    train phase's bf16 tolerances (L 2^-8 relative, 2 L 2^-8 relative L2),
    (a)'s prefill logits within L 2^-8 relative L2, its greedy tokens
    equal wherever the reference's top-2 gap is above twice the prefill's
    largest logit error, every rank the same tokens, its step's loss and
    grad norm; every rank's attention calls at the per-rank head counts,
    its RMSNorm calls at held shapes, ms and peak memory printed. Returns
    the ranks' launch counts, summed."""
    import tempfile
    import torch.multiprocessing as mp
    from collections import Counter
    from repro_torch import sharding as Sh
    from repro_torch.core.mesh import MeshShape, axis_sizes
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs = {}
    for part, arch in (("a", "qwen3-8b"), ("b", "qwen3-moe-30b-a3b")):
        refs[part] = _tp_program(torch, tp_config(arch)[0], None, part)
    t_ref = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_tp_rank, args=(ZOO_TP_RANKS, out_dir),
                                 nprocs=ZOO_TP_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + ZOO_TP_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"zoo tp: the spawned world ran past"
                                         f" {ZOO_TP_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt")
                 for r in range(ZOO_TP_RANKS)]
    t_world = time.perf_counter() - t_phase - t_ref
    mesh = MeshShape(ZOO_TP_MESH, ("data", "model"))
    sizes = axis_sizes(mesh)
    counts = Counter()
    for part, arch in (("a", "qwen3-8b"), ("b", "qwen3-moe-30b-a3b")):
        cfg, full = tp_config(arch)
        L, ref = cfg.num_layers, refs[part]
        outs = [r[part] for r in ranks]
        for o in outs:
            for key in ("loss_and_grad", "train", "prefill", "serve"):
                counts.update(o["launches"].get(key, {}))
        tol_loss, tol_grad = ((TRAIN_LOSS_TOL, ZOO_TP_F32_GRAD_TOL)
                              if cfg.param_dtype == "float32"
                              else (L * 2 ** -8, 2 * L * 2 ** -8))
        specs = _tp_named(Sh.param_specs(T.init_params(0, cfg, device="meta"),
                                         cfg, mesh), bool(cfg.num_experts))
        grad_err = {
            name: _tp_rel_l2(torch, [(r["coord"], r[part]["grads"][name])
                                     for r in ranks], ref["grads"][name],
                             spec if i is None else spec[1:], sizes)
            for name, (spec, i) in specs.items()}
        flips = [_flips(o["routes"], ref["routes"]) for o in outs]
        err = {"loss": max(abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
                           for o in outs),
               "routing_flips": flips,
               "grad_norm": max(abs(o["grad_norm_lg"] - ref["grad_norm_lg"])
                                / ref["grad_norm_lg"] for o in outs),
               "grads": grad_err}
        bad = [k for k in ("loss", "grad_norm") if err[k] > tol_loss] + [
            k for k, e in grad_err.items() if e > tol_grad]
        line = {"arch": cfg.name, "layers": f"{L} of {full.num_layers}",
                "mesh": dict(sizes), "batch": ZOO_TP_TRAIN[0],
                "seq": ZOO_TP_TRAIN[1], "num_micro": ref["num_micro"],
                "dtype": cfg.param_dtype, "errors": err,
                "tol": {"loss_rel": tol_loss, "grad_rel_l2": tol_grad},
                "none": {k: ref[k] for k in (
                    "loss", "grad_norm_lg", "loss_and_grad_ms", "peak_gb",
                    "train_ms", "prefill_ms") if k in ref}}
        if part == "a":
            lg_ref = ref["prefill"]
            lg = torch.cat([r["a"]["prefill"] for r in sorted(
                ranks, key=lambda r: r["coord"]["model"])], dim=-1)
            rel = _rel_l2(lg, lg_ref)
            max_err = (lg - lg_ref).abs().max().item()
            if rel > tol_loss:
                bad.append("prefill")
            want, gaps = ref["serve"], ref["serve_gaps"]
            for o in outs:
                if not torch.equal(o["serve"], outs[0]["serve"]):
                    bad.append("serve tokens differ between ranks")
            parted = []
            for b in range(want.shape[0]):
                diff = (outs[0]["serve"][b] != want[b]).nonzero()
                if len(diff):
                    t = int(diff[0])
                    parted.append((b, t, float(gaps[b, t])))
                    if float(gaps[b, t]) >= 2 * max_err:
                        bad.append(f"serve row {b} at step {t}")
            for o in outs:
                if abs(o["train_loss"] - ref["train_loss"]) > tol_loss * abs(
                        ref["train_loss"]) or abs(
                        o["grad_norm"] - ref["grad_norm"]) > tol_loss * abs(
                        ref["grad_norm"]):
                    bad.append("train step metrics")
                if o["cache_kv_heads"] != cfg.num_kv_heads // ZOO_TP_MESH[1]:
                    bad.append("cache kv heads")
            line.update(prefill={"batch": ZOO_TP_PREFILL[0],
                                 "seq": ZOO_TP_PREFILL[1], "rel_l2": rel,
                                 "max_abs_err": max_err,
                                 "tol_rel_l2": tol_loss},
                        serve={"batch": ZOO_TP_SERVE[0],
                               "steps": ZOO_TP_SERVE[1],
                               "cache": ZOO_TP_SERVE[2], "parted": parted,
                               "tokens_equal": not parted},
                        train_step={"loss": [o["train_loss"] for o in outs],
                                    "grad_norm": [o["grad_norm"]
                                                  for o in outs],
                                    "none_loss": ref["train_loss"],
                                    "none_grad_norm": ref["grad_norm"]})
        heads = (cfg.num_heads // ZOO_TP_MESH[1],
                 cfg.num_kv_heads // ZOO_TP_MESH[1])
        for r, o in enumerate(outs):
            # a rank's kv heads, and its query heads (the prefill's and
            # the train step's calls) or its kv heads' rows (decode's)
            wrong = [c for c, _ in o["flash_calls"]
                     if c[3] != heads[1] or c[2] not in heads]
            if not o["flash_calls"] or wrong or o["rms_unheld"]:
                bad.append(f"rank {r}: attention calls {wrong}, unheld "
                           f"RMSNorm {o['rms_unheld']}")
            print(f"zoo tp ({part}) rank {r}", json.dumps({
                "coord": ranks[r]["coord"],
                **{k: o[k] for k in ("loss", "grad_norm_lg",
                                     "loss_and_grad_ms", "train_ms",
                                     "prefill_ms", "serve_ms_per_step",
                                     "peak_gb", "cache_kv_heads") if k in o},
                "attention_calls": o["flash_calls"],
                "rmsnorm_calls": o["rms_calls"],
                "launches": o["launches"],
                "collectives": o["collectives"]}) + f"; {card}", flush=True)
        print(f"zoo tp ({part})", json.dumps(line) + f"; {card}", flush=True)
        if bad:
            raise AssertionError(f"zoo tp ({part}): {bad}")
    print(f"zoo tp: phase {time.perf_counter() - t_phase:.1f} s (mesh=None "
          f"{t_ref:.1f} s, the spawned world {t_world:.1f} s); launches "
          f"{dict(counts)}; two ranks share one card over gloo through host"
          f" memory; {card}", flush=True)
    return {"zoo_tp": dict(counts)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.agg import kernel as agg_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel

    t_start = time.perf_counter()

    def done(phase):
        print(f"chip_smoke: {phase} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi.splitlines()[0], flush=True)      # name, power limit

    # 2. build, all sources at once; beside it, on the host's CPU alone,
    # the launch phase's dry run (d), waited for before any phase is timed
    dryrun = start_dryrun()
    try:
        for b in build.build([agg_kernel.SOURCE, rms_kernel.SOURCE,
                              flash_kernel.SOURCE, flash_kernel.SOURCE_TC,
                              flash_kernel.SOURCE_BWD_TC,
                              flash_kernel.SOURCE_TC256,
                              flash_kernel.SOURCE_BWD_TC256]):
            print(f"built {b.source.relative_to(ROOT)} -> "
                  f"{b.library.relative_to(ROOT)} in {b.seconds:.1f} s",
                  flush=True)
            print(b.log.strip(), flush=True)
            if b.source in (flash_kernel.SOURCE_TC,
                            flash_kernel.SOURCE_BWD_TC):
                _ptxas(b.log, "tc")
            if b.source == flash_kernel.SOURCE_TC256:
                _ptxas(b.log, "tc256")
            if b.source == flash_kernel.SOURCE_BWD_TC256:
                _ptxas(b.log, "bwd256")
            if b.source == flash_kernel.SOURCE:
                _ptxas(b.log, "short")
            if b.source == agg_kernel.SOURCE:
                _ptxas(b.log, "agg")
        done("build")
        _finish_dryrun(dryrun)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()
    done("dry run")

    # 3. kernels against their plain versions
    agg_rows = check_aggregation(torch)
    rms_rows = check_rmsnorm(torch)
    flash_rows = check_flash(torch)
    decode_rows = check_flash_decode(torch)
    call = trace_attention_call(torch)
    print("attention call", json.dumps(call), flush=True)
    seen = call["kernels_per_call"]
    if call["copy_kernels_per_call"] or len(seen) != 2 or not all(
            any(name in n for n in seen) for name in SHORT_KERNELS.values()):
        raise AssertionError(f"the path's attention call ran {seen}, not "
                             f"the two short-sequence kernels alone")
    done("kernel checks")

    # 4, 5. the main paths
    paths = {"quickstart": run_main_path(torch)}
    done("quickstart path")
    run_fastloop_path(torch)
    done("fastloop path")
    paths["transformer"] = run_transformer_path(torch)
    done("transformer path")
    trace_aggregations_apart()
    done("aggregation traces")
    paths["fedspace"] = run_fedspace_path(torch)
    done("fedspace path")
    paths.update(run_densenet_path(torch))
    done("densenet path")
    paths.update(run_scenarios_path(torch))
    done("scenarios path")
    paths.update(run_faults_path(torch))
    done("faults path")
    paths.update(run_compression_path(torch))
    done("compression path")
    paths.update(run_replan_path(torch))
    done("replan path")
    paths.update(run_cli_path(torch))
    done("cli path")
    paths.update(run_zoo_path(torch))
    done("zoo path")
    families, family_launches = run_families_path(torch)
    paths.update(families)
    done("families path")
    # one world-1 NCCL group (`core.mesh.init_world`) for Part B's host
    # mesh (train (c)) and the mesh phases, started outside any timed
    # wall and ended last: ending it leaves a thread behind
    # (scripts/mesh_phase_after_cost.py), so no timed phase of this
    # process runs after it (the zoo tp phase's timed ranks are processes
    # of their own)
    import torch.distributed as dist
    from repro_torch.core.mesh import init_world
    init_world("cuda")
    try:
        paths.update(run_train_path(torch, t_start))
        done("train path")
        launch, launch_rows = run_launch_path(torch)
        paths.update(launch)
        done("launch path")
        paths.update(run_mesh_path(torch, smi))
        done("mesh path")
    finally:
        dist.destroy_process_group()
    # tensor parallelism on a spawned gloo world of two ranks on the card,
    # after the NCCL group has ended
    paths.update(run_zoo_tp_path(torch, smi))
    done("zoo tp path")

    # 6. the kernels line. One aggregation of the quickstart (one launch
    # over its flat model at M=20, float32); one SGD step of a
    # 20-satellite group on the transformer path (5 RMSNorm and 2
    # attention calls, each way).
    def launches(kernel_name):
        return {p: c.get(kernel_name, 0) for p, c in paths.items()}

    (r,) = [r for r in agg_rows if r["n"] == QUICKSTART_N
            and r["m"] == MAIN_PATH_M and r["updates"] == "float32"]
    kernels = [{
        "name": agg_kernel.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/agg/csrc/agg.cu",
        "replaces": "src/repro/kernels/agg/kernel.py:35",
        "launches": sum(launches(agg_kernel.NAME).values()),
        "launches_by_path": launches(agg_kernel.NAME),
        "max_abs_err": max(x["max_abs_err"] for x in agg_rows),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "design": r["design"],
        "work": "one quickstart aggregation: one launch over N = 4,622 at "
                "M = 20, float32",
    }]
    (r,) = [r for r in agg_rows if r["n"] == DENSENET_N
            and r["m"] == DENSENET_M and r["updates"] == "float32"]
    kernels[0]["densenet"] = {
        "work": "one DenseNet aggregation: one launch over N = 12,512 at "
                "M = 8, float32",
        **{k: r[k] for k in ("design", "max_abs_err", "bound_ms", "bound_by",
                             "plain_ms", "library_ms")}, "ms": r["kernel_ms"]}
    kernels[0]["launch"] = {
        "work": "the launch tools at full width, bf16 params: the agg step "
                "of whisper-base's agg_m96 (M 96, bf16 updates) and of "
                "qwen3-8b at M 2 (bf16 updates, N past 2^31), one launch a "
                "step; the FL round of mamba2-370m's flround_m16 (M 16, "
                "float32 updates), one launch a params dtype (its bf16 "
                "group here)",
        **{name: {k: r[k] for k in (
            "m", "n", "params", "updates", "design", "max_abs_err",
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share")} for name, r in launch_rows.items()}}
    path_shapes = (
        (rms_rows, "rmsnorm", 5, "src/repro_torch/kernels/rmsnorm/csrc/"
         "rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:28",
         lambda r: (r["G"], r["R"], r["D"]) == RMS_PATH
         and r["dtype"] == "float32" and r["x_offset"] == 0,
         f"one SGD step of a 20-satellite group: 5 calls at (G, R, D) = "
         f"{RMS_PATH}, float32; no one PyTorch call takes a scale row per "
         f"satellite"),
        (flash_rows, "flash_attention", 2, "src/repro_torch/kernels/"
         "flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:91",
         lambda r: (r["B"], r["H"], r["K"], r["Sq"], r["Sk"], r["hd"],
                    r["causal"], r["window"], r["dtype"]) == FLASH_PATH,
         "one SGD step of a 20-satellite group: 2 calls at (B, H, K, S, hd)"
         " = (640, 4, 2, 8, 8), causal, float32"))
    for rows, base, calls, source, replaces, at_path, what in path_shapes:
        for kname in (base, base + "_bwd"):
            mine = [r for r in rows if r["kernel"] == kname]
            (r,) = [r for r in mine if at_path(r)]
            kernels.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches(kname).values()),
                "launches_by_path": launches(kname),
                "max_abs_err": max(x["max_abs_err"] for x in mine),
                "ms": calls * r["kernel_ms"],
                "plain_ms": calls * r["plain_ms"],
                "bound_ms": calls * r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": (calls * r["library_ms"]
                               if r["library_ms"] is not None else None),
                "work": what,
            })
    for kname, tc_name, short_name in (
            (flash_kernel.NAME, flash_kernel.NAME_TC, flash_kernel.NAME_SHORT),
            (flash_kernel.NAME_BWD, flash_kernel.NAME_BWD_TC,
             flash_kernel.NAME_BWD_SHORT)):
        entry = next(k for k in kernels if k["name"] == kname)
        entry["launches_tc"] = sum(launches(tc_name).values())
        entry["launches_short"] = sum(launches(short_name).values())
        # per call at the path's shape: the short kernel's device time and
        # the older CUDA-core kernels' on the same inputs
        (r,) = [r for r in flash_rows if r["kernel"] == kname and (
            r["B"], r["H"], r["K"], r["Sq"], r["Sk"], r["hd"], r["causal"],
            r["window"], r["dtype"]) == FLASH_PATH]
        entry.update(device_us_per_call=r["device_us"],
                     cuda_core_device_us_per_call=r["cuda_core_device_us"],
                     bound_ms_per_call=r["bound_ms"])
    # the zoo's calls: qwen3-8b's prefill and decode step
    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "route")

    def pick(rows, kname, shape, names):
        (r,) = [r for r in rows if r["kernel"] == kname and tuple(
            r[n] for n in names) == shape]
        return {k: r[k] for k in keys if k in r}
    flash_names = ("B", "H", "K", "Sq", "Sk", "hd", "causal", "window",
                   "dtype")
    next(k for k in kernels if k["name"] == flash_kernel.NAME)["zoo"] = {
        "work": "qwen3-8b: the prefill's call at (B, H, K, S, hd) = (1, 32, "
                "8, 2048, 128) causal bf16, 36 a prefill; the decode step's "
                "at B 8 over a cache prefix of 576, its 4 query heads a kv "
                "head as 4 query rows, 36 a step",
        "prefill": pick(flash_rows, flash_kernel.NAME, FLASH_ZOO,
                        flash_names),
        "decode": pick(decode_rows, flash_kernel.NAME, FLASH_DECODE_PATH,
                       flash_names)}
    rms_names = ("G", "R", "D", "dtype", "x_offset")
    next(k for k in kernels if k["name"] == rms_kernel.NAME)["zoo"] = {
        "work": "qwen3-8b: the prefill's block norm at (1, 2048, 4096) and "
                "the decode step's at (1, 8, 4096), bf16; 145 calls a "
                "forward (4 a layer and the final norm)",
        "prefill": pick(rms_rows, rms_kernel.NAME,
                        (1, 2048, 4096, "bfloat16", 0), rms_names),
        "decode": pick(rms_rows, rms_kernel.NAME,
                       (*RMS_ZOO_DECODE, "bfloat16", 0), rms_names)}
    # the families' calls: each full-width config's prefill and decode
    by_arch = {arch: {k: n for k, n in c.items()
                      if k.startswith(("flash_attention", "rmsnorm"))}
               for arch, c in family_launches.items()}
    next(k for k in kernels if k["name"] == flash_kernel.NAME)[
        "families"] = {
        "work": "the families at full width, bf16: recurrentgemma-9b's "
                "local layers at (B, H, K, S, hd) = (1, 16, 1, 4096, 256) "
                "causal with a 2,048 window on the hd-256 tensor-core "
                "forward, 12 a prefill, and its decode calls (16 query rows of the one "
                "kv head over 160 and 2,048 keys), 12 a step; "
                "phi-3-vision's (1, 32, 32, 2048, 96 padded to 128) causal "
                "on the tensor cores, 32 a prefill, decode over 160 keys; "
                "whisper-base's encoder (8, 8, 8, 1500, 64) and "
                "cross-attention (448 over 1,500) without a mask, decoder "
                "(448) causal, 18 a prefill, 6 an encoder pass, 12 a step",
        "calls": {
            "recurrentgemma-9b": {
                "prefill": pick(flash_rows, flash_kernel.NAME, FLASH_RG,
                                flash_names),
                "decode_full_window": pick(decode_rows, flash_kernel.NAME,
                                           FLASH_DECODE_RG, flash_names)},
            "phi-3-vision-4.2b": {
                "prefill": pick(flash_rows, flash_kernel.NAME, FLASH_PHI3,
                                flash_names),
                "decode": pick(decode_rows, flash_kernel.NAME,
                               FLASH_DECODE_FAMILIES[2], flash_names)},
            "whisper-base": {
                part: pick(flash_rows, flash_kernel.NAME, shape,
                           flash_names)
                for part, shape in (("encoder", FLASH_WHISPER_ENC),
                                    ("decoder", FLASH_WHISPER_DEC),
                                    ("cross", FLASH_WHISPER_CROSS))} | {
                "decode_cross": pick(decode_rows, flash_kernel.NAME,
                                     FLASH_DECODE_FAMILIES[4],
                                     flash_names)}},
        "launches_by_arch": by_arch}
    next(k for k in kernels if k["name"] == rms_kernel.NAME)["families"] = {
        "work": "the families at full width, bf16, a shared scale: "
                "recurrentgemma-9b's at (1, 4096, 4096) a prefill and (1, "
                "8, 4096) a step, 77 calls each; phi-3-vision's at (1, "
                "2048, 3072) and (1, 8, 3072), 65; whisper-base's "
                "encoder's at (1, 12000, 512), 13, its decoder's at (1, "
                "3584, 512), 19 a prefill, and (1, 8, 512), 19 a step",
        "calls": {part: pick(rms_rows, rms_kernel.NAME,
                             (*shape, "bfloat16", 0), rms_names)
                  for part, shape in (
                      ("recurrentgemma_prefill", (1, 4096, 4096)),
                      ("phi3_prefill", (1, 2048, 3072)),
                      ("phi3_decode", (1, 8, 3072)),
                      ("whisper_encoder", (1, 12000, 512)),
                      ("whisper_decoder", (1, 3584, 512)),
                      ("whisper_decode", (1, 8, 512)))},
        "launches_by_arch": by_arch}
    # the train step's backward calls: qwen3-8b's at the prefill's shapes
    # (a microbatch is one sequence of 2,048)
    next(k for k in kernels if k["name"] == flash_kernel.NAME_BWD)[
        "train"] = {
        "work": "qwen3-8b's train step (8 layers, B 2 x S 2048 in 2 "
                "microbatches): the backward at (B, H, K, S, hd) = (1, 32, "
                "8, 2048, 128) causal bf16 on the tensor cores, 16 a step",
        "call": pick(flash_rows, flash_kernel.NAME_BWD, FLASH_ZOO,
                     flash_names)}
    next(k for k in kernels if k["name"] == rms_kernel.NAME_BWD)[
        "train"] = {
        "work": "qwen3-8b's train step: the block norms' backward at (1, "
                "2048, 4096) bf16, the q-norm's at (1, 65536, 128), the "
                "k-norm's at (1, 16384, 128); 66 calls a step (4 a layer "
                "and the final norm, a microbatch); Part B's mamba2-370m "
                "(B 4 x S 64, bf16): block and final norms at (1, 256, "
                "1024), out_norm at (1, 256, 2048)",
        **{part: pick(rms_rows, rms_kernel.NAME_BWD, (*shape, "bfloat16", 0),
                      rms_names)
           for part, shape in (("block", (1, 2048, 4096)),
                               ("q_norm", (1, 65536, 128)),
                               ("k_norm", (1, 16384, 128)),
                               ("part_b_block", (1, 256, 1024)),
                               ("part_b_out_norm", (1, 256, 2048)))}}
    rms_launch = (1, 4096, 1024, "bfloat16", 0)
    for kname in (rms_kernel.NAME, rms_kernel.NAME_BWD):
        next(k for k in kernels if k["name"] == kname)["launch"] = {
            "work": "the FL round of mamba2-370m (B 8 x S 512, bf16): "
                    "block and final norms at (1, 4096, 1024), out_norm at "
                    "(1, 4096, 2048)",
            "block": pick(rms_rows, kname, rms_launch, rms_names),
            "out_norm": pick(rms_rows, kname, (1, 4096, 2048, "bfloat16", 0),
                             rms_names)}
    # the zoo tp phase's calls of a rank at a model axis of 2
    tp_work = ("a rank of the zoo tp phase (mesh (1, 2), two ranks on the "
               "card): qwen3-8b's prefill and train calls at (B, H, K, S, "
               "hd) = (1, 16, 4, 2048, 128) causal bf16, one a layer and "
               "microbatch; qwen3-moe-30b-a3b's at (1, 16, 2, 2048, 128) "
               "float32 on the CUDA cores")
    for kname in (flash_kernel.NAME, flash_kernel.NAME_BWD):
        entry = next(k for k in kernels if k["name"] == kname)
        entry["zoo_tp"] = {
            "work": tp_work,
            "qwen3_8b": pick(flash_rows, kname, FLASH_TP, flash_names),
            "qwen3_moe": pick(flash_rows, kname, FLASH_TP_MOE, flash_names)}
    next(k for k in kernels if k["name"] == flash_kernel.NAME)["zoo_tp"][
        "decode"] = {
        "work": "qwen3-8b's decode call of a rank at B 8: its 4 kv heads' 4 "
                "query rows each over the serve loop's last prefix of 8",
        **pick(decode_rows, flash_kernel.NAME, FLASH_DECODE_TP, flash_names)}
    # the hd-256 tensor-core forward and its combine: recurrentgemma-9b's
    # prefill call and its full-window decode call
    (rg,) = [r for r in flash_rows if r["kernel"] == flash_kernel.NAME and (
        tuple(r[n] for n in flash_names) == FLASH_RG)]
    (rg_dec,) = [r for r in decode_rows if r["kernel"] == flash_kernel.NAME
                 and tuple(r[n] for n in flash_names) == FLASH_DECODE_RG]
    (comb,) = [r for r in decode_rows if r["kernel"] == "flash_combine"]
    tc256_rows = [r for r in flash_rows + decode_rows
                  if r["kernel"] == flash_kernel.NAME
                  and r["route"] == "tc256"]
    source = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_tc256.cu"
    kernels.append({
        "name": "flash_fwd_tc256", "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
        "launches": sum(launches(flash_kernel.NAME_TC256).values()),
        "launches_by_path": launches(flash_kernel.NAME_TC256),
        "max_abs_err": max(r["max_abs_err"] for r in tc256_rows),
        **{k: rg[k] for k in ("plain_ms", "bound_ms", "bound_by",
                              "library_ms", "cuda_core_ms")},
        "ms": rg["kernel_ms"],
        "work": "recurrentgemma-9b's prefill call at (B, H, K, S, hd) = "
                "(1, 16, 1, 4096, 256), causal, window 2,048, bf16, 12 a "
                "prefill; its decode calls (16 query rows of the kv head, "
                "B 8) 12 a step",
        "decode": {**{k: rg_dec[k] for k in (
            "max_abs_err", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cuda_core_ms", "splits", "ms_by_splits")},
            "ms": rg_dec["kernel_ms"],
            "work": "recurrentgemma-9b's full-window decode call: B 8, 16 "
                    "rows over 2,048 keys, split, with its combine"}})
    kernels.append({
        "name": "flash_combine", "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
        "launches": sum(launches(flash_kernel.NAME_COMBINE).values()),
        "launches_by_path": launches(flash_kernel.NAME_COMBINE),
        **{k: comb[k] for k in ("max_abs_err", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "splits")},
        "ms": comb["kernel_ms"],
        "work": "the combine of recurrentgemma-9b's full-window decode "
                "call: its splits' partial o and lse (B 8, 16 rows, hd "
                "256) merged, one launch a split call"})
    # the hd-256 tensor-core backward: recurrentgemma-9b's train call (a
    # microbatch's local layer), and gemma3-12b's at hd 240
    (rg_bwd,) = [r for r in flash_rows if r["kernel"] == flash_kernel.NAME_BWD
                 and tuple(r[n] for n in flash_names) == FLASH_RG]
    (gemma_bwd,) = [r for r in flash_rows
                    if r["kernel"] == flash_kernel.NAME_BWD and tuple(
                        r[n] for n in flash_names) == FLASH_GEMMA_TRAIN]
    bwd256_keys = ("max_abs_err", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "cuda_core_ms", "groups", "ms_by_parts",
                   "max_abs_err_by_parts", "device_us_by_kernel")
    kernels.append({
        "name": flash_kernel.NAME_BWD_TC256, "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_bwd_tc256.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
        "launches": sum(launches(flash_kernel.NAME_BWD_TC256).values()),
        "launches_by_path": launches(flash_kernel.NAME_BWD_TC256),
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["kernel"] == flash_kernel.NAME_BWD
                           and r["route"] == "tc256"),
        **{k: rg_bwd[k] for k in bwd256_keys if k != "max_abs_err"},
        "ms": rg_bwd["kernel_ms"], "ms_by_groups": rg_bwd["ms_by_groups"],
        "work": "recurrentgemma-9b's train step's backward call at (B, H, "
                "K, S, hd) = (1, 16, 1, 4096, 256), causal, window 2,048, "
                "bf16, one a local layer and microbatch (4 a step at 6 "
                "layers, B 2 x S 4096), split into head groups and merged",
        "gemma3_12b": {**{k: gemma_bwd[k] for k in bwd256_keys},
                       "ms": gemma_bwd["kernel_ms"],
                       "work": "gemma3-12b's local layer at hd 240 padded "
                               "to 256, (1, 16, 8, 4096), window 1,024, "
                               "bf16 (no path runs it)"}})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on a main "
                                 f"path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
