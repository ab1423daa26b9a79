#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card
and hold it against its references.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  Phases, each printing one JSON line:

  device               card name and power limit (nvidia-smi), versions
  build                nvcc builds the six kernel sources from the
                       checkout, and netstep with its body cut out (the
                       launch floor; kernels.ablate's `empty` cut), one
                       process per source, all started together; netstep's
                       library and ptxas lines, which must report no spill
  build_lm             the same build's flash_attention and ssd_scan
                       libraries (bf16 tensor-core and f32 CUDA-core
                       route of each) and their ptxas lines; the hd 256
                       flash instantiations' registers and spill bytes
  sass                 cuobjdump -sass of every library: HGMMA / HMMA /
                       MATCH / REDUX counts; the bf16 flash kernel must
                       hold HGMMA, the bf16 SSD kernels HGMMA or HMMA,
                       netstep MATCH (its arbitration)
  kernel_vs_plain      the CUDA netstep equals its plain PyTorch version
                       on the card, bit for bit, plus the allocation
                       invariants: the cases of tests/test_torch_cuda.py,
                       random shapes, every PI in LANE_PIS x V in LANE_VS
                       on rows whose warps straddle two rows, ROW_SHAPES
                       and the main path's shape; a misaligned input
                       raises and an empty one launches nothing
  sim_kernel_vs_plain  the simulator's counters with the kernel, with
                       the plain allocator on the card, and on the CPU
                       are equal (the CPU path is held against the JAX
                       package by the CPU tests)
  main_path            mesh, hexamesh and folded_hexa_torus at N = 256
                       (organic, uniform, default SimConfig) through
                       SweepEngine.run_specs; counters equal the JAX
                       reference's, and every cycle went through the
                       kernel and the fused cycle kernels (cycle_route,
                       cycle_move and sim.fused_cycles: one a cycle)
  timing               netstep at kernels.ablate's NETSTEP_SHAPES (the
                       main path's [32, 256, 7, 4], mesh's PI 5, the
                       widest radix's PI 31): the profiler's device time
                       per launch beside the bound and the launch floor
                       (the kernel with its body cut out, same grid);
                       CUDA-event time of back-to-back
                       wrapper calls (host-bound: minus the device time,
                       the wrapper's host time) and the plain version's
  profile              torch.profiler: the device busy/idle share of
                       simulated cycles at the main path's widest group
  cycle_kernels        at that group, static (the main path's settings)
                       and as perfbench's hotspot-adaptive cell runs it
                       (adaptive routing, the recorder in 6 windows, a
                       6-phase drifting hotspot): the fused body equals
                       the PyTorch body (alloc="torch") on the card in
                       every result key, bit for bit; from the fused
                       run's last state, cycle_route and cycle_move equal
                       their plain versions (kernels/cycle/ref.py) cycle
                       by cycle; each kernel's device time per launch
                       beside its byte bound and the plain version's
                       time, and the graphed loop's µs a cycle on each
                       body; the registers, stack and local bytes of
                       every instantiation (cuobjdump
                       --dump-resource-usage) and its ptxas lines
  workload_kernel_vs_plain
                       the heterogeneous workload batch of
                       tests/test_torch_workloads.py (multi-phase
                       schedules, ON/OFF bursts, a zero-intensity phase,
                       k_pad 6 > k): raw and per-phase counters with the
                       kernel, with the plain allocator on the card, and
                       on the CPU are equal
  experiments          the experiment API (Scenario -> plan -> execute ->
                       ResultFrame) at N = 256, organic, SimConfig(cycles=
                       2000, warmup=700), SaturationGrid(8): Fig. 4's six
                       principled topologies under uniform traffic, mesh
                       and folded_hexa_torus under three workloads, and
                       folded_hexa_torus under three fault sets (empty,
                       8 random links, 4 chiplets); every row ok, counters
                       and row values equal the JAX reference table, and
                       every cycle of every group went through the kernel.
                       Wall time, ms per simulated cycle per group (each
                       group's own, by kind), and the device launches per
                       cycle and idle share of the widest workload group
                       beside the `profile` phase's static group
  collectives          the collective workloads through the experiment
                       API at N = 64, SimConfig(cycles=2000, warmup=700),
                       SaturationGrid(8): on the six principled
                       topologies (organic) the training step of
                       qwen3-1.7b, of qwen3-moe-235b-a22b (with its MoE
                       all-to-all) and the MoE step beside a serving
                       tenant, and folded_hexa_torus and mesh on glass
                       under the qwen3-1.7b step: 20 scenarios, 160 rate
                       rows, every row ok, raw counters, per-phase
                       deliveries and row values equal to the JAX table,
                       every cycle of every group through the kernel; and
                       build_ici_model(use_sim=True) for folded_hexa_torus
                       and mesh at N = 64 equal to the JAX values
  adaptive_kernel_vs_plain
                       routing="adaptive" with the flight recorder on (4
                       windows): the heterogeneous batch of
                       tests/test_torch_simulator.py and the k_pad workload
                       batch, every result key (raw, per-phase, per-link,
                       per-node, histogram, windows) equal with the kernel,
                       with the plain allocator on the card and on the CPU
  adaptive_telemetry   adaptive routing and the recorder at N = 256 through
                       the experiment API: mesh, torus and folded_hexa_torus
                       under hotspot_drift, static and adaptive, organic,
                       SimConfig(cycles=2000, warmup=700, telemetry=True,
                       telemetry_windows=6), SaturationGrid(8): 6 scenarios,
                       48 rate rows, every row ok, equal to the JAX table
                       (raw and per-phase counters, saturation, link-load
                       columns, per-link counters, latency histogram,
                       window rows), every cycle of every group through the
                       kernel, recorder sums conserved (ejections,
                       injections, histogram) and windows summing to the
                       aggregates.  Static -> adaptive saturation gains,
                       wall time, ms per cycle by routing, one obs.profile
                       record per runner key (untimed pass), and device
                       launches per cycle, idle share and ms per cycle of
                       the widest adaptive group in each mode (routing x
                       recorder) beside the `profile` phase's static group
  synth                README's topology search on the card:
                       `synth.run_search(SearchConfig(n=48, substrate=
                       "organic", seed=0), device="cuda")` (3 generations,
                       1500 cycles, SaturationGrid(4)); stats, pool digest,
                       rejection ledger, every simulated candidate's
                       analytic and simulated metrics, the front and the
                       rows' CSV bytes equal the JAX table, FHT within 5%
                       of the front, prefilter >= 5, every cycle of every
                       padded group through the kernel.  Analytic and
                       simulate wall times, the padded groups, ms per
                       simulated cycle per group (the groups' cycle loops
                       alone, and stage 2 with its set-up), and the widest
                       group's device launches per cycle and idle share
                       beside the `profile` phase's static group
  synth_kernel_vs_plain
                       every padded group of the search's stage 2 (PI 4,
                       5, 7, 9), 300 cycles with the kernel and with the
                       plain allocator on the card: every result key equal
  analysis             `python -m repro_torch.analysis --all-builtin
                       --hazards` in a process of its own, and
                       `analyze(names=["folded_hexa_torus"], n=36,
                       fault_kmax=2)`: exit code and DP, RT, JX001-JX003
                       diagnostics equal the JAX table, the JX004 / JX005
                       findings are runner_hazards.INTENDED; the hazard
                       pass's traced cycles ran on the card (every loop op
                       on cuda but the stated host-side ones) under
                       torch.cuda's sync debug mode, with no wait for the
                       card inside the loop; the hazard pass's group (PI
                       11), 300 cycles with the kernel and with the plain
                       allocator on the card, every result key equal
  flash_vs_plain       the flash-attention kernels against their plain
                       version on the card: every case of
                       tests/test_torch_cuda.py (five (tq, tk, causal,
                       window) x hd 16/32/64/128/256, GQA 4:2) through both
                       routes, f32 (2e-5) and bf16 (2e-2), and qwen3-1.7b's
                       prefill shape [4, 1024, 16 (8 kv), 128] causal
                       through both; at hd 256, GQA 4:1, causal with
                       window None / 1024 / 96 at T 2048 and on ragged
                       128 / 256 pairs, and gemma3-1b's prefill shape
                       [4, 2048, 4 (1 kv), 256] global and local; the
                       families' prefill shapes through both: seamless
                       [4, 1024, 16 (16 kv), 64], jamba [4, 1024, 32 (8
                       kv), 128], qwen3-moe [4, 1024, 64 (4 kv), 128]
  ssd_vs_plain         the SSD-scan kernels against their plain version:
                       the shapes of tests/test_torch_cuda.py through both
                       routes, f32 (1e-4) and bf16 (3e-2), the bf16
                       route's any-chunk shapes, and mamba2-1.3b's prefill
                       shape (B 4, T 1024, H 64, P 64, N 128, chunk 256)
                       and jamba's (B 4, T 1024, H 128, P 64, N 64, chunk
                       256): bf16 at 3e-2, f32 no further from the f64
                       evaluation of the plain version than the plain f32
                       version (x 2); y and the final state
  lm_card_vs_cpu       qwen3-1.7b, gemma3-1b and mamba2-1.3b at full
                       width, depth 2,
                       f32 compute, batch 1, prompt 256: prefill logits and
                       4 decode steps with the kernels on the card, with
                       the plain path on the card, and on the CPU (the path
                       the CPU tests hold against the JAX package) agree
                       within 1e-3; in bf16 the kernel path's prefill
                       logits agree with the plain path's within 0.08
  serve                the serving path: `launch.serve.main` at full depth
                       and width for each arch (batch 4, prompt 1024 --
                       2048 for gemma3-1b, so that its 1024 window masks
                       in prefill and its ring caches wrap in decode --,
                       gen 32, bf16); 28 (qwen3-1.7b) and 26 (gemma3-1b)
                       flash and 48 SSD launches per prefill.  Prefill logits with the kernels on and
                       off, in bf16 and f32: in f32 the two agree within
                       1e-3; in bf16 each differs from the f32 logits by
                       its own rounding, and the kernel path may differ no
                       more than the plain path (x 1.1).  Prefill ms,
                       decode ms per token, tokens/s, peak memory and the
                       decode loop's device idle share
  lm_timing_f32        CUDA-event times of the f32 routes at the serving
                       shapes
  lm_timing            CUDA-event times of the bf16 (serving) routes at the
                       serving shapes, their plain versions and bounds, and
                       SDPA beside flash attention
  lm_timing_hd256      the same at gemma3-1b's prefill shape, both routes,
                       global (causal) and local (window 1024) layers, SDPA
                       at the global layers' shape
  lm_timing_families   the same (bf16) at the families' flash and SSD
                       shapes, with each call's graph-replay device ms
  lm_profile           torch.profiler: the device time of every CUDA kernel
                       one wrapper call launches, summed, per route (the
                       bf16 SSD call launches four), and the device idle
                       share of each arch's decode loop; and each call's
                       device ms from the replay of a CUDA graph of 20
                       back-to-back calls (kernels.ablate.graph_ms: no host
                       work between launches, no profiler misses), the
                       kernels line's `ms` for flash attention and SSD
  train_parity         the training path (no kernel runs on it):
                       qwen3-1.7b's smoke config at f32 compute through
                       the train driver's loop (`launch.train.run`), 8
                       steps of SyntheticLMData(seed=0) at batch 4 x seq
                       32 from `train_smoke_params`, whole and with 2
                       microbatches: each step's loss and grad norm equal
                       the JAX table REFERENCE_TRAIN (1e-4); stopped after
                       its step-4 checkpoint and resumed in a fresh model
                       and optimizer, it equals the uninterrupted run
  train_card_vs_cpu    qwen3-1.7b at full width (d 2048, vocab 151936, hd
                       128), depth 2, f32: one train step on the card and
                       on the CPU give the same loss, grad norm and
                       updated parameters (1e-4)
  train_full           qwen3-1.7b at full width and depth, bf16, remat
                       "full", batch 4 x seq 1024, 10 steps through the
                       driver: the first step's loss within 0.02 of an f32
                       no-grad forward; median ms per step after 2,
                       tokens/s, model FLOPs and MFU, peak memory, device
                       launches per step and idle share (torch.profiler),
                       the optimizer update's ms and launches
  train_remat_memory   12 steps on one batch take the loss down by 0.5 or
                       more (tests/test_models.py::test_loss_decreases);
                       at batch 1 x 1024 each remat mode's peak memory,
                       of the loss and gradient alone and of a whole step
  train_kernels        with grad enabled the flash and SSD wrappers raise
                       on the card, directly and from a train step with the
                       kernel flags set; no kernel launched in training
  families_parity      the model families' smoke configs (minicpm3-4b: MLA,
                       seamless-m4t-medium: encoder-decoder, qwen3-moe-
                       235b-a22b and grok-1-314b: MoE, the latter with
                       virtual-split experts, jamba-v0.1-52b: Mamba2 +
                       attention + MoE) at f32 from `train_smoke_params`:
                       prefill logits, two decode steps and the train
                       driver's first loss (MoE aux included) and grad
                       norm equal the JAX table REFERENCE_FAMILIES (1e-4)
  moe_vs_plain         one full-width MoE layer of qwen3-moe and of jamba,
                       bf16, at the prefill token count (4096) and the
                       decode count (4): the card's grouped route
                       (`torch._grouped_mm`) against the per-expert loop on
                       the card (2e-2); their ms and the host's waits for
                       the card per call
  families_kernel_vs_plain
                       minicpm3, seamless, qwen3-moe at full width, depth
                       2, and jamba at depth 5 (its first attention layer
                       is layer 4), f32, batch 1, prompt 256, 4 decode
                       steps: the kernel flags on (one flash launch per
                       attention layer, one SSD launch per Mamba2 layer)
                       and off agree within 1e-3; minicpm3 and seamless
                       also on the CPU
  families_serve       serving through `launch.serve.generate`, bf16,
                       seed-0 weights, batch 4, prompt 1024, 32 new
                       tokens, full width: minicpm3-4b and seamless at
                       full depth, jamba at 5 layers, qwen3-moe at 2;
                       flash and SSD launches per prefill (0 / 0, 12 / 0,
                       1 / 4, 2 / 0), prefill ms, decode ms per token, peak
                       memory, the host's waits in one decode step, and
                       the decode loop's device launches per token and
                       idle share
  sharded              the sharded paths on a 1 x 1 NCCL mesh
                       (`launch.mesh.make_host_mesh()`): qwen3-moe at full
                       width, 2 of 94 layers, bf16, through `Model(cfg,
                       ctx)` (decode layout) and `launch.serve.generate`,
                       batch 4, prompt 1024, 32 new tokens; prefill takes
                       `moe_ep_local` (4096 tokens), decode
                       `moe_ep_stationary`.  At capacity_factor 16 (no
                       token dropped) against the unsharded model: in f32
                       its prefill logits and 32 teacher-forced decode
                       steps (1e-3) and its greedy tokens (equal); in
                       bf16 one MoE layer on one input at 4096 and 4
                       tokens (2e-2, and its ms beside the grouped
                       route's), the sharded bf16 model's mean distance
                       from the f32 logits at most 1.1 x the unsharded
                       bf16 model's (prefill and decode), their tokens
                       reported; at the config's 1.25 the
                       share of (token, expert) pairs dropped in prefill
                       and decode, prefill ms, decode ms per token, device
                       launches per token, host waits per decode step
                       (0), collectives per decode step by kind
                       (CommDebugMode), flash launches per prefill (2) and
                       peak memory.  Then `decode_attention_dist` at
                       qwen3-1.7b's decode shape, f32, against the dense
                       decode (2e-5, the cache bit for bit); qwen3-1.7b,
                       depth 2, f32, with sequence parallelism forced on
                       (the grouped attention layout) against the
                       unsharded prefill (1e-3); and its parameters saved
                       from the unsharded model and restored onto the
                       mesh's placements, bit for bit
  sharded_train        the sharded train step on a 1 x 1 NCCL mesh:
                       qwen3-1.7b at full width, depth 2, f32, three
                       `make_train_step` steps on `Model(cfg, ctx)` against
                       the unsharded step (loss, grad norm, parameters, m,
                       v within 1e-5 relative); at full depth, bf16,
                       `launch.train.run` for TRAIN_FULL's 10 steps, each
                       loss within 1e-3 (relative) of the unsharded
                       `train_full` losses, with ms per step, tokens/s,
                       MFU, peak memory, device launches and idle share,
                       host waits (0) and collectives per step, flash / SSD
                       launches (0); its step-5 checkpoint restored
                       unsharded takes step 6 bit for bit; one qwen3-moe
                       MoE layer at full width, f32, capacity factor 16:
                       the input's and every expert weight's gradients
                       through `moe_ep_local` and `moe_ep_stationary`
                       within 1e-4 (relative) of the dropless loop route
  examples             the nine scripts of examples_torch/, each through
                       its main(argv) in this process with no --device
                       (the card): the six simulator examples at the
                       reference examples' sizes write files whose SHA-256
                       and print result lines equal to REFERENCE_EXAMPLES
                       (the unedited reference scripts on a CPU), every
                       one through the netstep kernel; serve_lm at
                       qwen3-1.7b's full width and depth, batch 4, prompt
                       1024, 32 new tokens, names cuda, launches flash 28
                       times and gives the greedy tokens of
                       launch.serve.main with the same argv; train_lm at
                       full width, 4 x 1024, 20 steps: finite losses,
                       the last below the first; topology_collectives on the
                       record of `python -m repro_torch.launch.dryrun`
                       (qwen3-1.7b train_4k, one microbatch) prices all
                       four topologies, folded_hexa_torus below mesh.
                       Seconds per script, prefill ms, decode ms per
                       token and ms per step as the scripts print them

then the kernel summary line and, last, the `{"ok": true, ...}` line.
A failed check raises and exits non-zero before the last line; without
a card, or without the repository beside this script, it exits
non-zero and prints no result.
"""
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# JAX reference counters at the main path's size: repro.core.simulator
# with alloc="jnp" (jax 0.9.0 on a CPU), default SimConfig() (3000
# cycles, 1000 warm-up, 4 VCs x 4-flit buffers, seed 0), organic
# substrate, uniform traffic, N = 256, rates
# saturation_rate_grid(routing.saturation_rate(traffic), 8).  The
# simulator's counters are integers, so these must match bit for bit.
REFERENCE = {
    "mesh": dict(
        delivered=[3603, 7151, 10740, 12738, 12283, 11924, 11768, 11276],
        lat_sum=[304973, 616232, 959917, 2246205, 3021439, 2948171,
                 3304723, 3441612],
        sim_saturation=0.02487890625),
    "hexamesh": dict(
        delivered=[22664, 45463, 67800, 69265, 65288, 61522, 56805, 54240],
        lat_sum=[1568243, 3172082, 5282642, 11221118, 13505928, 13806762,
                 14094872, 13753158],
        sim_saturation=0.135283203125),
    "folded_hexa_torus": dict(
        delivered=[24861, 49802, 73208, 70506, 63518, 59881, 58073, 56588],
        lat_sum=[1260341, 2549688, 4689692, 10100895, 11972611, 13244444,
                 13279182, 12902656],
        sim_saturation=0.142984375),
}
MAIN_N = 256

# JAX reference of the `experiments` phase: `tools/smoke_reference.py`
# (repro.experiments.run with alloc="jnp", jax 0.9.0 on a CPU) on the
# Experiment `experiment_scenarios` builds, scenario by scenario: raw
# counters over the 8-point rate grid, the tidy row's values at the
# saturating rate, and (workloads) the per-phase deliveries there.  The
# counters are integers and the row values are numpy of them, so these
# must match bit for bit.
REFERENCE_EXPERIMENTS = [
    dict(label='mesh/uniform/none',
         delivered=[2368, 4676, 6993, 8314, 8139, 8034, 7764, 7331],
         lat_sum=[199047, 400337, 630889, 1194673, 1470656, 1558682, 1703548,
                  1778263],
         sim_saturation=0.024981971153846153,
         abs_throughput_gbps=77.54403846153846,
         latency_ns=143.69413038248737),
    dict(label='folded_torus/uniform/none',
         delivered=[2880, 5768, 8619, 9407, 9087, 8639, 8057, 7858],
         lat_sum=[221909, 453846, 731646, 1297808, 1597691, 1661566, 1601833,
                  1727471],
         sim_saturation=0.028266225961538462,
         abs_throughput_gbps=85.10168075353464,
         latency_ns=137.9619432337621),
    dict(label='hexamesh/uniform/none',
         delivered=[14632, 29449, 44374, 45169, 42412, 40138, 36891, 35263],
         lat_sum=[1013608, 2055933, 3361492, 6923902, 8324840, 8881828,
                  8943044, 8898048],
         sim_saturation=0.13572415865384616,
         abs_throughput_gbps=271.4483173076923,
         latency_ns=153.28880426841417),
    dict(label='folded_hexa_torus/uniform/none',
         delivered=[16051, 32295, 47467, 46313, 42922, 40499, 39139, 38797],
         lat_sum=[814028, 1652852, 3040795, 6089932, 7556166, 8205217, 8090907,
                  8417803],
         sim_saturation=0.14262920673076923,
         abs_throughput_gbps=270.1372001162826,
         latency_ns=64.06124254745401),
    dict(label='octamesh/uniform/none',
         delivered=[11242, 22673, 34108, 43345, 46436, 46203, 44236, 43200],
         lat_sum=[678266, 1366971, 2104131, 3391103, 4942355, 6648644, 7389478,
                  7929886],
         sim_saturation=0.13953125,
         abs_throughput_gbps=201.22534451492882,
         latency_ns=106.43369368593332),
    dict(label='folded_octa_torus/uniform/none',
         delivered=[19632, 39506, 59325, 71466, 67546, 64828, 63227, 62964],
         lat_sum=[867497, 1764568, 2757385, 5267873, 7738581, 8394601, 9105663,
                  9595848],
         sim_saturation=0.21474158653846154,
         abs_throughput_gbps=277.6942460985383,
         latency_ns=73.7115971231075),
    dict(label='mesh/hotspot_drift/none',
         delivered=[2090, 4120, 5622, 6359, 6615, 6859, 6851, 6954],
         lat_sum=[184088, 668773, 1548695, 2131989, 2483375, 2977063, 3351400,
                  3803460],
         sim_saturation=0.020895432692307692,
         abs_throughput_gbps=64.85942307692308,
         latency_ns=546.9456427955133,
         delivered_ph=[1334, 949, 1196, 962, 1120, 1393]),
    dict(label='mesh/phase_alternating/none',
         delivered=[3924, 7817, 11649, 13950, 13914, 13465, 13300, 12962],
         lat_sum=[290319, 608867, 1130870, 2193565, 2620896, 2726656, 2795384,
                  2748036],
         sim_saturation=0.041917067307692304,
         abs_throughput_gbps=130.1105769230769,
         latency_ns=157.24480286738353,
         delivered_ph=[3543, 3425, 3634, 3348]),
    dict(label='mesh/bursty_uniform/none',
         delivered=[2382, 4729, 7246, 8534, 8415, 8147, 7919, 7436],
         lat_sum=[203976, 409210, 675555, 1178413, 1425333, 1475446, 1668526,
                  1736090],
         sim_saturation=0.025643028846153847,
         abs_throughput_gbps=79.59596153846154,
         latency_ns=138.0844855870635,
         delivered_ph=[8534]),
    dict(label='folded_hexa_torus/hotspot_drift/none',
         delivered=[3196, 6377, 8806, 9646, 9009, 8055, 7229, 6697],
         lat_sum=[254877, 1258626, 2879065, 3898222, 4102848, 3902521, 3746991,
                  3727328],
         sim_saturation=0.028984375,
         abs_throughput_gbps=54.895894670437606,
         latency_ns=404.12834335475844,
         delivered_ph=[1771, 1629, 1597, 1242, 1593, 1814]),
    dict(label='folded_hexa_torus/phase_alternating/none',
         delivered=[13422, 27049, 40594, 39848, 30403, 30528, 29199, 27697],
         lat_sum=[618416, 1267661, 2107344, 3968530, 4451056, 4980174, 5592307,
                  5888774],
         sim_saturation=0.12197716346153846,
         abs_throughput_gbps=231.02259467673068,
         latency_ns=51.912696457604575,
         delivered_ph=[10021, 10190, 10209, 10174]),
    dict(label='folded_hexa_torus/bursty_uniform/none',
         delivered=[16877, 34116, 47792, 46861, 42689, 43077, 43077, 43077],
         lat_sum=[863020, 1823839, 3569350, 6256966, 7873059, 7617283, 7617283,
                  7617283],
         sim_saturation=0.14360576923076923,
         abs_throughput_gbps=271.9867922547744,
         latency_ns=74.685093739538,
         delivered_ph=[47792]),
    dict(label='folded_hexa_torus/uniform/none',
         delivered=[16051, 32295, 47467, 46313, 42922, 40499, 39139, 38797],
         lat_sum=[814028, 1652852, 3040795, 6089932, 7556166, 8205217, 8090907,
                  8417803],
         sim_saturation=0.14262920673076923,
         abs_throughput_gbps=270.1372001162826,
         latency_ns=64.06124254745401),
    dict(label='folded_hexa_torus/uniform/rand:k8:s0',
         delivered=[15031, 30298, 45089, 46841, 43557, 39958, 38024, 38869],
         lat_sum=[766458, 1559547, 2708164, 5568926, 7063005, 8002289, 8150890,
                  8398520],
         sim_saturation=0.1407481971153846,
         abs_throughput_gbps=266.57460110491064,
         latency_ns=118.88998953907901),
    dict(label='folded_hexa_torus/uniform/chip:k4:s0',
         delivered=[13038, 26298, 38889, 34051, 30352, 28046, 27207, 26049],
         lat_sum=[670087, 1366551, 2454827, 5141469, 6552670, 6987495, 7073043,
                  6936805],
         sim_saturation=0.11685396634615385,
         abs_throughput_gbps=221.31934976556585,
         latency_ns=63.12394250302142),
]
EXP_CYCLES, EXP_WARMUP, EXP_RATES = 2000, 700, 8
# The `collectives` phase: LLM training collectives (and a serving tenant
# beside them) on N = 64 chiplets at the benchmarks' SimConfig.  Its JAX
# reference table, REFERENCE_COLLECTIVES, comes from the same tool.
COLL_N = 64
PRINCIPLED = ("mesh", "folded_torus", "hexamesh", "folded_hexa_torus",
              "octamesh", "folded_octa_torus")
ICI_TOPOLOGIES = ("folded_hexa_torus", "mesh")
ICI_BYTES = 2 ** 30
EXP_FAULTS = ((8, "random"), (4, "chiplets"))
# JAX reference of the `collectives` phase: `tools/smoke_reference.py
# collectives` (repro.experiments.run with alloc="jnp", jax 0.9.0 on a
# CPU) on the Experiment `collective_scenarios` builds, scenario by
# scenario (labels topology/substrate/traffic/faults): the raw counters over
# the 8-point rate grid, the tidy row's values and the per-phase deliveries
# at the saturating rate; and `build_ici_model(name, 64, "organic",
# use_sim=True)` on ICI_TOPOLOGIES (default SimConfig): its effective
# bandwidth and its all-reduce time for ICI_BYTES.  Bit for bit, as above.
REFERENCE_COLLECTIVES = dict(
    table=[
        dict(label='mesh/organic/collective:qwen3-1.7b/none',
             delivered=[18477, 26568, 34457, 42338, 50029, 57503, 63789,
                        68784],
             offered_n=[18475, 26569, 34450, 42395, 50275, 58407, 66406,
                        74469],
             accepted_n=[18475, 26569, 34446, 42341, 50033, 57485, 63764,
                         68789],
             lat_sum=[260123, 375530, 495186, 629988, 786013, 988668, 1205386,
                      1419703],
             sim_saturation=0.8267307692307693,
             abs_throughput_gbps=2566.1723076923076,
             latency_ns=20.640018027448242,
             delivered_ph=[4439, 29201, 29903, 5241]),
        dict(label='mesh/organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[11570, 16697, 21704, 26736, 31055, 34490, 37573,
                        40479],
             offered_n=[11560, 16668, 21679, 26822, 31751, 36806, 41806,
                        46858],
             accepted_n=[11560, 16668, 21675, 26735, 31074, 34499, 37545,
                         40472],
             lat_sum=[190563, 278568, 371691, 490384, 659595, 876377, 1040300,
                      1168547],
             sim_saturation=0.4865264423076923,
             abs_throughput_gbps=1510.178076923077,
             latency_ns=28.867980928382618,
             delivered_ph=[12491, 4330, 8008, 2377, 13273]),
        dict(label='mesh/organic/mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[4683, 9517, 14249, 15998, 15130, 15079, 14917, 14458],
             offered_n=[4668, 9497, 14319, 19204, 24164, 28869, 33708, 38520],
             accepted_n=[4668, 9497, 14273, 16100, 15298, 15146, 14985, 14492],
             lat_sum=[132670, 274179, 452481, 1166496, 1518367, 1729321,
                      1870683, 1912880],
             sim_saturation=0.19228365384615384,
             abs_throughput_gbps=596.8484615384615,
             latency_ns=72.91511438929867,
             delivered_ph=[4555, 1460, 3776, 1445, 4762]),
        dict(label='folded_torus/organic/collective:qwen3-1.7b/none',
             delivered=[7736, 15640, 23307, 27511, 29864, 31656, 33060, 34175],
             offered_n=[7727, 15615, 23514, 31415, 39240, 47105, 54942, 62920],
             accepted_n=[7727, 15614, 23267, 27503, 29815, 31627, 33036,
                         34156],
             lat_sum=[156402, 331569, 649036, 1219743, 1540156, 1751700,
                      1915955, 2049528],
             sim_saturation=0.41075721153846156,
             abs_throughput_gbps=1236.6747910075674,
             latency_ns=59.97155815654718,
             delivered_ph=[3303, 13633, 13347, 3892]),
        dict(label='folded_torus/organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[11559, 16667, 21565, 26096, 29502, 31888, 33212,
                        34062],
             offered_n=[11560, 16668, 21679, 26822, 31751, 36806, 41806,
                        46858],
             accepted_n=[11560, 16655, 21538, 26054, 29494, 31909, 33243,
                         34039],
             lat_sum=[239036, 364764, 524857, 750626, 994700, 1266587, 1511880,
                      1686885],
             sim_saturation=0.40939903846153847,
             abs_throughput_gbps=1232.585712693482,
             latency_ns=49.52395631495508,
             delivered_ph=[9866, 2582, 8756, 2236, 10622]),
        dict(label='folded_torus/'
                   'organic/mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[5568, 11342, 17007, 17666, 16997, 15677, 15258, 15284],
             offered_n=[5546, 11293, 17084, 22931, 28601, 34368, 40063, 45771],
             accepted_n=[5546, 11293, 17010, 17724, 17049, 15645, 15214,
                         15262],
             lat_sum=[155365, 318514, 546795, 1323627, 1731155, 1826339,
                      1876209, 1942932],
             sim_saturation=0.21233173076923076,
             abs_throughput_gbps=639.2713052798736,
             latency_ns=74.92511038152384,
             delivered_ph=[4850, 1282, 4582, 1565, 5387]),
        dict(label='hexamesh/organic/collective:qwen3-1.7b/none',
             delivered=[18477, 26568, 34457, 42338, 50030, 57498, 63726,
                        68668],
             offered_n=[18475, 26569, 34450, 42395, 50275, 58407, 66406,
                        74469],
             accepted_n=[18475, 26569, 34446, 42341, 50034, 57480, 63701,
                         68673],
             lat_sum=[260142, 375619, 495618, 631542, 790229, 997323, 1222837,
                      1444367],
             sim_saturation=0.8253365384615384,
             abs_throughput_gbps=1650.673076923077,
             latency_ns=21.03406244538941,
             delivered_ph=[4364, 29194, 29903, 5207]),
        dict(label='hexamesh/organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[11576, 16694, 21693, 26738, 31131, 34834, 37520,
                        40358],
             offered_n=[11560, 16668, 21679, 26822, 31751, 36806, 41806,
                        46858],
             accepted_n=[11560, 16668, 21670, 26724, 31174, 34802, 37498,
                         40363],
             lat_sum=[190846, 278859, 372956, 494721, 671762, 891020, 1080229,
                      1206107],
             sim_saturation=0.48507211538461537,
             abs_throughput_gbps=970.1442307692307,
             latency_ns=29.885202438178304,
             delivered_ph=[12304, 4235, 8116, 2438, 13265]),
        dict(label='hexamesh/organic/'
                   'mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[12854, 19348, 25833, 31802, 36622, 40645, 42807,
                        43562],
             offered_n=[12821, 19325, 25811, 32203, 38548, 44925, 51320,
                        57654],
             accepted_n=[12821, 19324, 25773, 31767, 36606, 40644, 42714,
                         43530],
             lat_sum=[315488, 481741, 664445, 918114, 1230746, 1547348,
                      1860020, 2120604],
             sim_saturation=0.5235817307692308,
             abs_throughput_gbps=1047.1634615384614,
             latency_ns=48.68013406179698,
             delivered_ph=[13810, 3329, 9531, 2707, 14185]),
        dict(label='folded_hexa_torus/organic/collective:qwen3-1.7b/none',
             delivered=[5238, 10636, 15926, 21062, 25814, 29833, 33201, 35833],
             offered_n=[5233, 10618, 15948, 21375, 26788, 32064, 37415, 42763],
             accepted_n=[5233, 10618, 15917, 21049, 25800, 29812, 33216,
                         35822],
             lat_sum=[99938, 205487, 329675, 502892, 702296, 929423, 1152160,
                      1362314],
             sim_saturation=0.43068509615384615,
             abs_throughput_gbps=815.7099704440352,
             latency_ns=38.018418775988614,
             delivered_ph=[2521, 15067, 15203, 3042]),
        dict(label='folded_hexa_torus/'
                   'organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[7121, 12777, 18436, 23772, 28512, 32514, 35861, 38073],
             offered_n=[7119, 12777, 18514, 24236, 29873, 35519, 41187, 46858],
             accepted_n=[7119, 12776, 18424, 23748, 28498, 32525, 35872,
                         38077],
             lat_sum=[133129, 247339, 388712, 567115, 772229, 981302, 1208997,
                      1428642],
             sim_saturation=0.4576081730769231,
             abs_throughput_gbps=866.7018029390717,
             latency_ns=37.52375699314475,
             delivered_ph=[10908, 2824, 10658, 2840, 10843]),
        dict(label='folded_hexa_torus/'
                   'organic/mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[8518, 15542, 22637, 28891, 34013, 36220, 38132, 40466],
             offered_n=[8508, 15517, 22683, 29702, 36707, 43657, 50697, 57654],
             accepted_n=[8508, 15516, 22616, 28915, 34030, 36275, 38211,
                         40496],
             lat_sum=[188202, 347690, 538255, 813037, 1137451, 1524135,
                      1805415, 1998550],
             sim_saturation=0.4863701923076923,
             abs_throughput_gbps=921.1765597072066,
             latency_ns=49.388375426283794,
             delivered_ph=[12163, 2965, 11417, 3059, 10862]),
        dict(label='octamesh/organic/collective:qwen3-1.7b/none',
             delivered=[7723, 15616, 23516, 31201, 38653, 45912, 52839, 59172],
             offered_n=[7727, 15615, 23514, 31415, 39240, 47105, 54942, 62920],
             accepted_n=[7727, 15615, 23489, 31188, 38637, 45902, 52839,
                         59159],
             lat_sum=[107623, 220863, 354330, 500701, 643142, 792302, 962935,
                      1158088],
             sim_saturation=0.7112019230769231,
             abs_throughput_gbps=1025.6616492064234,
             latency_ns=19.57155411343203,
             delivered_ph=[3741, 25473, 25660, 4298]),
        dict(label='octamesh/organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[11578, 16688, 21566, 26321, 30565, 34623, 38298,
                        41682],
             offered_n=[11560, 16668, 21679, 26822, 31751, 36806, 41806,
                        46858],
             accepted_n=[11560, 16667, 21541, 26260, 30509, 34613, 38315,
                         41685],
             lat_sum=[191740, 285965, 404495, 542257, 688100, 838829, 978906,
                      1115862],
             sim_saturation=0.5009855769230769,
             abs_throughput_gbps=722.4976147877735,
             latency_ns=26.770836332229738,
             delivered_ph=[12289, 4178, 8921, 3468, 12826]),
        dict(label='octamesh/organic/'
                   'mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[13423, 19868, 26233, 31984, 36783, 39188, 41606,
                        41974],
             offered_n=[13402, 19847, 26220, 32528, 38788, 45108, 51404,
                        57654],
             accepted_n=[13402, 19845, 26172, 31916, 36750, 39110, 41553,
                         41940],
             lat_sum=[302200, 456575, 627365, 874273, 1134810, 1480696,
                      1707573, 1978993],
             sim_saturation=0.5044951923076924,
             abs_throughput_gbps=727.5590154767528,
             latency_ns=47.14806785152714,
             delivered_ph=[14133, 3752, 9021, 2751, 12317]),
        dict(label='folded_octa_torus/organic/collective:qwen3-1.7b/none',
             delivered=[6804, 13748, 20733, 27177, 32123, 35902, 38726, 41155],
             offered_n=[6806, 13741, 20734, 27676, 34555, 41487, 48343, 55317],
             accepted_n=[6806, 13741, 20716, 27185, 32118, 35891, 38686,
                         41115],
             lat_sum=[124763, 255963, 421457, 695732, 981586, 1246415, 1466498,
                      1662300],
             sim_saturation=0.4946514423076923,
             abs_throughput_gbps=639.6611926334393,
             latency_ns=40.391203984935004,
             delivered_ph=[3154, 16918, 17414, 3669]),
        dict(label='folded_octa_torus/'
                   'organic/collective:qwen3-moe-235b-a22b/none',
             delivered=[7758, 13330, 18952, 24272, 28905, 32848, 35981, 38443],
             offered_n=[7755, 13326, 18976, 24601, 30126, 35689, 41288, 46858],
             accepted_n=[7755, 13326, 18943, 24250, 28891, 32801, 35961,
                         38482],
             lat_sum=[143233, 250788, 378497, 545235, 749886, 981775, 1211877,
                      1400104],
             sim_saturation=0.4620552884615385,
             abs_throughput_gbps=597.5092996818688,
             latency_ns=36.42025856462815,
             delivered_ph=[10874, 2769, 10564, 3010, 11226]),
        dict(label='folded_octa_torus/'
                   'organic/mixed:qwen3-moe-235b-a22b+uniform0.3/none',
             delivered=[10300, 17095, 24024, 30497, 36424, 40753, 44729,
                        47022],
             offered_n=[10282, 17069, 23998, 30680, 37450, 44197, 50966,
                        57654],
             accepted_n=[10282, 17069, 23987, 30476, 36402, 40759, 44793,
                         47001],
             lat_sum=[210584, 352659, 511854, 701431, 942889, 1234924, 1478191,
                      1752680],
             sim_saturation=0.5651682692307692,
             abs_throughput_gbps=730.850409428006,
             latency_ns=37.27361660499341,
             delivered_ph=[13880, 3184, 12752, 3354, 13852]),
        dict(label='folded_hexa_torus/glass/collective:qwen3-1.7b/none',
             delivered=[5238, 10636, 15926, 21062, 25814, 29833, 33201, 35833],
             offered_n=[5233, 10618, 15948, 21375, 26788, 32064, 37415, 42763],
             accepted_n=[5233, 10618, 15917, 21049, 25800, 29812, 33216,
                         35822],
             lat_sum=[99938, 205487, 329675, 502892, 702296, 929423, 1152160,
                      1362314],
             sim_saturation=0.43068509615384615,
             abs_throughput_gbps=1267.936923076923,
             latency_ns=38.018418775988614,
             delivered_ph=[2521, 15067, 15203, 3042]),
        dict(label='mesh/glass/collective:qwen3-1.7b/none',
             delivered=[18477, 26568, 34457, 42338, 50029, 57503, 63789,
                        68784],
             offered_n=[18475, 26569, 34450, 42395, 50275, 58407, 66406,
                        74469],
             accepted_n=[18475, 26569, 34446, 42341, 50033, 57485, 63764,
                         68789],
             lat_sum=[260123, 375530, 495186, 629988, 786013, 988668, 1205386,
                      1419703],
             sim_saturation=0.8267307692307693,
             abs_throughput_gbps=3730.209230769231,
             latency_ns=20.640018027448242,
             delivered_ph=[4439, 29201, 29903, 5241]),
    ],
    ici={
        'folded_hexa_torus': dict(b_eff_gbps=799.1569744624435,
                                  all_reduce_s=0.021161847254366876),
        'mesh': dict(b_eff_gbps=285.49525,
                     all_reduce_s=0.05923602172687428),
    })
# The `adaptive_telemetry` phase: adaptive routing and the flight recorder
# at N = 256 through the experiment API.  mesh, torus and folded_hexa_torus
# under the `experiments` phase's hotspot_drift (6 x 200 cycles), each once
# static and once adaptive, organic, SimConfig(cycles=2000, warmup=700,
# telemetry=True, telemetry_windows=6), SaturationGrid(8).  JAX reference:
# `tools/smoke_reference.py adaptive` (alloc="jnp", jax 0.9.0 on a CPU)
# through `adaptive_table`: the raw counters over the rate grid, the tidy
# row's saturation and link-load columns, and at the saturating rate the
# latency histogram; per-phase counters, per-link counters and the
# link_rows' escape / adaptive occupancy columns as SHA-256 digests, and
# the window_rows of the last scenario as the digest of their JSON.
ADAPTIVE_TOPOLOGIES = ("mesh", "torus", "folded_hexa_torus")
ADAPTIVE_WINDOWS = 6
ADAPTIVE_ROW_KEYS = ("sim_saturation", "link_util_p95", "link_util_max",
                     "link_gini")
REFERENCE_ADAPTIVE = dict(
    table=[
    dict(label='mesh/hotspot_drift/static',
         delivered=[2090, 4120, 5622, 6359, 6615, 6859, 6851, 6954],
         offered_n=[2076, 4131, 6183, 8199, 10225, 12245, 14316, 16425],
         accepted_n=[2076, 4129, 6071, 7507, 8205, 8404, 8214, 7902],
         lat_sum=[184088, 668773, 1548695, 2131989, 2483375, 2977063, 3351400,
                  3803460],
         sim_saturation=0.020895432692307692,
         link_util_p95=0.236308,
         link_util_max=0.813846,
         link_gini=0.703528,
         lat_hist=[0, 0, 0, 0, 43, 129, 479, 794, 813, 1322, 2449, 925, 0, 0,
                   0, 0],
         per_phase=('043c57934b386cf0545d3c3e6d9a7f62'
                    '62331b88af404a4d253c8e7e5bbb7fc7'),
         link_counters=('efede25541b17f37bfb9c602a3a601e3'
                        '0d282397dfadb3d987a972f084d40fcb'),
         link_occ_columns=('23ffaff8c5aa9b799c91bf7ff75c9c88'
                           '43b96d86da69584b75fe935da9e5196c')),
    dict(label='mesh/hotspot_drift/adaptive',
         delivered=[2091, 5359, 7721, 9091, 9511, 8489, 7459, 6102],
         offered_n=[2076, 5305, 8516, 11670, 14896, 18167, 21470, 24773],
         accepted_n=[2076, 5304, 8227, 10299, 11214, 10597, 9221, 7443],
         lat_sum=[182236, 1020135, 2360478, 3570514, 4411359, 4291074, 4185923,
                  3748295],
         sim_saturation=0.028578725961538463,
         link_util_p95=0.263231,
         link_util_max=0.712308,
         link_gini=0.569658,
         lat_hist=[0, 0, 0, 0, 106, 283, 748, 1122, 1184, 2083, 3261, 724, 0,
                   0, 0, 0],
         per_phase=('7dd46c6186cce6b18066c7191cbcb2b9'
                    '3a17c0c01ed4d9a84b08dea4de7620f5'),
         link_counters=('7119b899a1d3c4cf4e6b5fd0c9280724'
                        'b409ab39f36e56261130ef9fafa1d94c'),
         link_occ_columns=('a58b577355ac2a0a99a68a0be8d2d816'
                           '2eaeeafa43fccc7c7765d1bbce1cc9ac')),
    dict(label='torus/hotspot_drift/static',
         delivered=[2402, 4647, 5944, 6660, 7242, 7029, 6997, 6139],
         offered_n=[2378, 4731, 7015, 9415, 11713, 14094, 16471, 18780],
         accepted_n=[2378, 4727, 6748, 8161, 8708, 8561, 8082, 6953],
         lat_sum=[207278, 880188, 1669827, 2354719, 3064897, 3359094, 3741118,
                  3612291],
         sim_saturation=0.021760817307692307,
         link_util_p95=0.227,
         link_util_max=0.779231,
         link_gini=0.66492,
         lat_hist=[0, 0, 0, 0, 70, 229, 642, 969, 1039, 1621, 2260, 412, 0, 0,
                   0, 0],
         per_phase=('93a020db3e3f7c517832fa0251929f26'
                    '219afe39cd5aefcebbc6947998290ead'),
         link_counters=('4669c2a0cac2707d373da07101595a20'
                        '9ed17080ec929116e12fbfa70c8366d7'),
         link_occ_columns=('d970787b4cb52f2e565915d9c800bc35'
                           '15050b118a11776fbe5d19e49a2708fa')),
    dict(label='torus/hotspot_drift/adaptive',
         delivered=[2405, 6038, 8404, 9416, 9064, 8447, 6768, 5976],
         offered_n=[2378, 6087, 9734, 13393, 17158, 20922, 24693, 28469],
         accepted_n=[2378, 6067, 9120, 10441, 10320, 9729, 7777, 6614],
         lat_sum=[205167, 1279082, 2950388, 4055858, 4313769, 4101804, 3632517,
                  3674082],
         sim_saturation=0.02829326923076923,
         link_util_p95=0.211423,
         link_util_max=0.611538,
         link_gini=0.56548,
         lat_hist=[0, 0, 0, 0, 88, 364, 867, 1421, 1221, 1924, 2827, 704, 0, 0,
                   0, 0],
         per_phase=('0119e670aadd5fbdc951e068f8826c83'
                    'a27b145fec90ce0374b8304ed350cbc0'),
         link_counters=('a1ee58da6a188f0442449f5e03e1e66c'
                        'f73a3e927ad165dd72aa425d15620dc0'),
         link_occ_columns=('f093b6b0ec7d0f31234adf4b117675d3'
                           '7550d68e69d579e45bb8df0bf8e00f88')),
    dict(label='folded_hexa_torus/hotspot_drift/static',
         delivered=[3196, 6377, 8806, 9646, 9009, 8055, 7229, 6697],
         offered_n=[3178, 6310, 9454, 12558, 15771, 18897, 22174, 25395],
         accepted_n=[3178, 6302, 9105, 10788, 10897, 10224, 9190, 8385],
         lat_sum=[254877, 1258626, 2879065, 3898222, 4102848, 3902521, 3746991,
                  3727328],
         sim_saturation=0.028984375,
         link_util_p95=0.109462,
         link_util_max=0.465385,
         link_gini=0.600137,
         lat_hist=[0, 0, 0, 0, 118, 493, 1242, 1076, 1184, 2013, 3141, 379, 0,
                   0, 0, 0],
         per_phase=('4e500393d12478f6855aede902be08ca'
                    'd4950343f54fc9973fbdbec2834f6deb'),
         link_counters=('ec3eef5306a6f723425b5b0b87c685e6'
                        'd8c5cceeee27380fc2d7d1fc48e956b3'),
         link_occ_columns=('5da92c48091c2135d722b6ea39dcbdce'
                           '0ccbbb1940ea2313505c906525c23b61')),
    dict(label='folded_hexa_torus/hotspot_drift/adaptive',
         delivered=[3194, 8088, 9894, 9415, 8987, 7803, 7320, 7236],
         offered_n=[3178, 8109, 13015, 18012, 23047, 28144, 33131, 38088],
         accepted_n=[3178, 8033, 11190, 11538, 11021, 9935, 9151, 9020],
         lat_sum=[259603, 2170835, 3893439, 3974509, 4048371, 3698246, 3715957,
                  3583508],
         sim_saturation=0.029729567307692308,
         link_util_p95=0.099231,
         link_util_max=0.502308,
         link_gini=0.55446,
         lat_hist=[0, 0, 0, 0, 113, 528, 1435, 1300, 1152, 1898, 3029, 439, 0,
                   0, 0, 0],
         per_phase=('3ccb2fb4a0dbca7c28d873a1fd9e8439'
                    '4b979ecdaceac87ad2704194a375c459'),
         link_counters=('c70100774d8aedfc82b4b4dd5647cf69'
                        '78b7ec4157dff784c69166dd1b5c5145'),
         link_occ_columns=('cd72ddfdac975733e3b626e3874bb26e'
                           'cbd9b171df708de57a24994c5f3c5f8c')),
    ],
    n_window_rows=9168,
    window_rows=('33d725a5867bcfea3ccf8e595090023e'
                 '87be87057cca9ef05e1e465877d5b9a2'))
# The `synth` phase: README's search, SearchConfig's defaults (N = 48,
# organic, seed 0: 3 generations, 32 random seeds, 16 offspring, sim_top
# 8, SaturationGrid(4), 1500 / 500 cycles).  REFERENCE_SYNTH is
# `tools/smoke_reference.py synth` (repro.synth.run_search, jax 0.9.0 on
# a CPU) through `synth_table`: search stats, a digest of the pool's
# sorted structural hashes, the rejection ledger, every simulated
# candidate's analytic and simulated metrics, the front (exact and 5 %),
# the prefilter ratio, a digest of `SearchResult.rows()`'s CSV bytes and
# stage 2's padded groups (N, P, C, D), in plan order.  Integer counters
# and numpy arithmetic on them, so the port must match bit for bit.
SYNTH_N = 48
REFERENCE_SYNTH = {'stats': {'n_generated': 153,
           'n_duplicate': 7,
           'n_infeasible': 47,
           'n_feasible': 99,
           'n_simulated': 16},
 'n_pool': 99,
 'pool': 'ffd7d5d4d9b2abfb9cb41b93950c22d5aa17a3c8f1d4c09f9328a348df3a3ccc',
 'rejected': [['torus',
               'registry',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['folded_octa_torus',
               'registry',
               ['link-range 2 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_pr',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_rp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_rf',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_fr',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_ppr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_prp',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_prr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_prf',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_pfr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_rpp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rpr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rpf',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rrp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rrr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rrf',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rfp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rfr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_rff',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_brick_fpr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_frp',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_frr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_frf',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_brick_ffr',
               'fold_mask',
               ['link-range 5 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_ppr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_ppf',
               'fold_mask',
               ['link-range 2 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_prp',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_prr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_prf',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_pfr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_pff',
               'fold_mask',
               ['link-range 2 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_rpp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rpr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rpf',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rrp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rrr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rrf',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rfp',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rfr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_rff',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_fpr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_fpf',
               'fold_mask',
               ['link-range 2 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_frp',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_frr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']],
              ['fm_grid_diag_frf',
               'fold_mask',
               ['link-range 4 > 1 (Principle 2)'],
               ['DP001']],
              ['fm_grid_diag_ffr',
               'fold_mask',
               ['link-range 6 > 1 (Principle 2)',
                'max link 61.9 mm > 50.0 mm (organic rate floor 0.25)'],
               ['DP001', 'DP002']]],
 'simulated': [{'name': 'mesh',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.15064102564102627,
                             'abs_throughput_gbps': 467.5897435897455,
                             'zero_load_latency_ns': 37.33333333333333,
                             'wire_cost_mm': 147844.27841088403,
                             'radix': 4,
                             'diameter': 12,
                             'avg_hops': 4.666666666666667,
                             'n_links': 82,
                             'max_link_mm': 8.752325267042629},
                'sim': {'analytic_saturation': 0.15064102564102627,
                        'abs_throughput_gbps': 379.7873333333333,
                        'zero_load_latency_ns': 37.33333333333333,
                        'wire_cost_mm': 147844.27841088403,
                        'radix': 4,
                        'diameter': 12,
                        'avg_hops': 4.666666666666667,
                        'n_links': 82,
                        'max_link_mm': 8.752325267042629,
                        'sim_saturation': 0.12235416666666667,
                        'latency_at_sat_ns': 53.23701685680231}},
               {'name': 'folded_torus',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.2034632034632036,
                             'abs_throughput_gbps': 612.5706562233466,
                             'zero_load_latency_ns': 31.54609929078014,
                             'wire_cost_mm': 295688.5568217681,
                             'radix': 4,
                             'diameter': 7,
                             'avg_hops': 3.574468085106383,
                             'n_links': 96,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.2034632034632036,
                        'abs_throughput_gbps': 503.9819177554565,
                        'zero_load_latency_ns': 31.54609929078014,
                        'wire_cost_mm': 295688.5568217681,
                        'radix': 4,
                        'diameter': 7,
                        'avg_hops': 3.574468085106383,
                        'n_links': 96,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.16739583333333333,
                        'latency_at_sat_ns': 47.751586807716244}},
               {'name': 'hexamesh',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.379032258064516,
                             'abs_throughput_gbps': 758.064516129032,
                             'zero_load_latency_ns': 30.921985815602834,
                             'wire_cost_mm': 150905.83508856053,
                             'radix': 6,
                             'diameter': 10,
                             'avg_hops': 3.8652482269503547,
                             'n_links': 117,
                             'max_link_mm': 9.78539712914816},
                'sim': {'analytic_saturation': 0.379032258064516,
                        'abs_throughput_gbps': 755.2916666666667,
                        'zero_load_latency_ns': 30.921985815602834,
                        'wire_cost_mm': 150905.83508856053,
                        'radix': 6,
                        'diameter': 10,
                        'avg_hops': 3.8652482269503547,
                        'n_links': 117,
                        'max_link_mm': 9.78539712914816,
                        'sim_saturation': 0.37764583333333335,
                        'latency_at_sat_ns': 85.19413030286313}},
               {'name': 'folded_hexa_torus',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.4122807017543861,
                             'abs_throughput_gbps': 780.8523722924122,
                             'zero_load_latency_ns': 22.97872340425532,
                             'wire_cost_mm': 299130.4713637345,
                             'radix': 6,
                             'diameter': 6,
                             'avg_hops': 2.7065602836879434,
                             'n_links': 140,
                             'max_link_mm': 19.570794258296317},
                'sim': {'analytic_saturation': 0.4122807017543861,
                        'abs_throughput_gbps': 756.132995198272,
                        'zero_load_latency_ns': 22.97872340425532,
                        'wire_cost_mm': 299130.4713637345,
                        'radix': 6,
                        'diameter': 6,
                        'avg_hops': 2.7065602836879434,
                        'n_links': 140,
                        'max_link_mm': 19.570794258296317,
                        'sim_saturation': 0.3992291666666667,
                        'latency_at_sat_ns': 77.61336951416793}},
               {'name': 'octamesh',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.4700000000000006,
                             'abs_throughput_gbps': 677.8116867871295,
                             'zero_load_latency_ns': 26.609929078014183,
                             'wire_cost_mm': 163165.04686004887,
                             'radix': 8,
                             'diameter': 7,
                             'avg_hops': 3.326241134751773,
                             'n_links': 152,
                             'max_link_mm': 12.377657094952406},
                'sim': {'analytic_saturation': 0.4700000000000006,
                        'abs_throughput_gbps': 569.4399334962966,
                        'zero_load_latency_ns': 26.609929078014183,
                        'wire_cost_mm': 163165.04686004887,
                        'radix': 8,
                        'diameter': 7,
                        'avg_hops': 3.326241134751773,
                        'n_links': 152,
                        'max_link_mm': 12.377657094952406,
                        'sim_saturation': 0.3948541666666667,
                        'latency_at_sat_ns': 70.85020841027806}},
               {'name': 'honeycomb_mesh',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.1350574712643685,
                             'abs_throughput_gbps': 568.3218390804627,
                             'zero_load_latency_ns': 45.51773049645389,
                             'wire_cost_mm': 149227.14580307677,
                             'radix': 3,
                             'diameter': 12,
                             'avg_hops': 5.3120567375886525,
                             'n_links': 62,
                             'max_link_mm': 8.752325267042629},
                'sim': {'analytic_saturation': 0.1350574712643685,
                        'abs_throughput_gbps': 416.855,
                        'zero_load_latency_ns': 45.51773049645389,
                        'wire_cost_mm': 149227.14580307677,
                        'radix': 3,
                        'diameter': 12,
                        'avg_hops': 5.3120567375886525,
                        'n_links': 62,
                        'max_link_mm': 8.752325267042629,
                        'sim_saturation': 0.0990625,
                        'latency_at_sat_ns': 104.63533123028391}},
               {'name': 'sid_mesh',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.18650793650793684,
                             'abs_throughput_gbps': 573.4147359005024,
                             'zero_load_latency_ns': 33.13475177304964,
                             'wire_cost_mm': 221757.31142947238,
                             'radix': 4,
                             'diameter': 7,
                             'avg_hops': 3.7109929078014185,
                             'n_links': 94,
                             'max_link_mm': 12.377657094952406},
                'sim': {'analytic_saturation': 0.18650793650793684,
                        'abs_throughput_gbps': 494.927068884929,
                        'zero_load_latency_ns': 33.13475177304964,
                        'wire_cost_mm': 221757.31142947238,
                        'radix': 4,
                        'diameter': 7,
                        'avg_hops': 3.7109929078014185,
                        'n_links': 94,
                        'max_link_mm': 12.377657094952406,
                        'sim_saturation': 0.16097916666666667,
                        'latency_at_sat_ns': 134.57486734825935}},
               {'name': 'kite_large',
                'origin': 'registry',
                'analytic': {'analytic_saturation': 0.17803030303030346,
                             'abs_throughput_gbps': 535.9993241954293,
                             'zero_load_latency_ns': 34.26950354609929,
                             'wire_cost_mm': 253442.1308833134,
                             'radix': 4,
                             'diameter': 9,
                             'avg_hops': 4.028368794326241,
                             'n_links': 88,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.17803030303030346,
                        'abs_throughput_gbps': 440.19229605573037,
                        'zero_load_latency_ns': 34.26950354609929,
                        'wire_cost_mm': 253442.1308833134,
                        'radix': 4,
                        'diameter': 9,
                        'avg_hops': 4.028368794326241,
                        'n_links': 88,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.14620833333333333,
                        'latency_at_sat_ns': 49.3660587061841}},
               {'name': 'fm_grid_diag_fpp~5974~461c',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.8245614035087722,
                             'abs_throughput_gbps': 1164.4825252731928,
                             'zero_load_latency_ns': 22.900709219858157,
                             'wire_cost_mm': 202830.58497028603,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.8351063829787235,
                             'n_links': 159,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.8245614035087722,
                        'abs_throughput_gbps': 863.5876736097822,
                        'zero_load_latency_ns': 22.900709219858157,
                        'wire_cost_mm': 202830.58497028603,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.8351063829787235,
                        'n_links': 159,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.6115,
                        'latency_at_sat_ns': 53.0990733169801}},
               {'name': 'fm_grid_diag_fpp~934e',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.8103448275862072,
                             'abs_throughput_gbps': 1144.4052403546896,
                             'zero_load_latency_ns': 23.0,
                             'wire_cost_mm': 201027.60596527526,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.851950354609929,
                             'n_links': 158,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.8103448275862072,
                        'abs_throughput_gbps': 841.1977097362116,
                        'zero_load_latency_ns': 23.0,
                        'wire_cost_mm': 201027.60596527526,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.851950354609929,
                        'n_links': 158,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.5956458333333333,
                        'latency_at_sat_ns': 53.93421006610472}},
               {'name': 'fm_grid_diag_fpp~070e~9233',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7966101694915257,
                             'abs_throughput_gbps': 1098.3813573100317,
                             'zero_load_latency_ns': 22.886524822695034,
                             'wire_cost_mm': 201079.822394188,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.8351063829787235,
                             'n_links': 157,
                             'max_link_mm': 19.570794258296313},
                'sim': {'analytic_saturation': 0.7966101694915257,
                        'abs_throughput_gbps': 784.8640761175254,
                        'zero_load_latency_ns': 22.886524822695034,
                        'wire_cost_mm': 201079.822394188,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.8351063829787235,
                        'n_links': 157,
                        'max_link_mm': 19.570794258296313,
                        'sim_saturation': 0.5692291666666667,
                        'latency_at_sat_ns': 56.561175566372654}},
               {'name': 'fm_grid_diag_fpp~5974',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7704918032786889,
                             'abs_throughput_gbps': 1088.1230154192133,
                             'zero_load_latency_ns': 22.9645390070922,
                             'wire_cost_mm': 201027.60596527523,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.8430851063829787,
                             'n_links': 158,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.7704918032786889,
                        'abs_throughput_gbps': 843.1689680535956,
                        'zero_load_latency_ns': 22.9645390070922,
                        'wire_cost_mm': 201027.60596527523,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.8430851063829787,
                        'n_links': 158,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.5970416666666667,
                        'latency_at_sat_ns': 54.38900132598227}},
               {'name': 'fm_grid_diag_fpp~5974~895d',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7704918032786889,
                             'abs_throughput_gbps': 1088.1230154192133,
                             'zero_load_latency_ns': 22.98581560283688,
                             'wire_cost_mm': 200126.11646276986,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.844858156028369,
                             'n_links': 157,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.7704918032786889,
                        'abs_throughput_gbps': 840.0502608648984,
                        'zero_load_latency_ns': 22.98581560283688,
                        'wire_cost_mm': 200126.11646276986,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.844858156028369,
                        'n_links': 157,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.5948333333333333,
                        'latency_at_sat_ns': 42.78992715046231}},
               {'name': 'fm_grid_diag_fpp~ff2a',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7230769230769236,
                             'abs_throughput_gbps': 1021.1615990857235,
                             'zero_load_latency_ns': 23.070921985815602,
                             'wire_cost_mm': 199752.70728449512,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.8599290780141846,
                             'n_links': 157,
                             'max_link_mm': 17.504650534085258},
                'sim': {'analytic_saturation': 0.7230769230769236,
                        'abs_throughput_gbps': 830.6647175328761,
                        'zero_load_latency_ns': 23.070921985815602,
                        'wire_cost_mm': 199752.70728449512,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.8599290780141846,
                        'n_links': 157,
                        'max_link_mm': 17.504650534085258,
                        'sim_saturation': 0.5881875,
                        'latency_at_sat_ns': 42.915843162256934}},
               {'name': 'fm_grid_diag_fpp~ff2a~9853',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7230769230769236,
                             'abs_throughput_gbps': 996.9923089429524,
                             'zero_load_latency_ns': 23.070921985815602,
                             'wire_cost_mm': 199592.11090981422,
                             'radix': 8,
                             'diameter': 6,
                             'avg_hops': 2.8652482269503547,
                             'n_links': 156,
                             'max_link_mm': 19.570794258296313},
                'sim': {'analytic_saturation': 0.7230769230769236,
                        'abs_throughput_gbps': 793.0508148246034,
                        'zero_load_latency_ns': 23.070921985815602,
                        'wire_cost_mm': 199592.11090981422,
                        'radix': 8,
                        'diameter': 6,
                        'avg_hops': 2.8652482269503547,
                        'n_links': 156,
                        'max_link_mm': 19.570794258296313,
                        'sim_saturation': 0.5751666666666667,
                        'latency_at_sat_ns': 44.35573022312373}},
               {'name': 'rg_grid_22b18bf1~aa86~7481',
                'origin': 'perturb',
                'analytic': {'analytic_saturation': 0.7121212121212127,
                             'abs_throughput_gbps': 981.8863648680591,
                             'zero_load_latency_ns': 21.411347517730494,
                             'wire_cost_mm': 228496.82440525628,
                             'radix': 8,
                             'diameter': 5,
                             'avg_hops': 2.5629432624113475,
                             'n_links': 147,
                             'max_link_mm': 19.570794258296317},
                'sim': {'analytic_saturation': 0.7121212121212127,
                        'abs_throughput_gbps': 788.2536731962455,
                        'zero_load_latency_ns': 21.411347517730494,
                        'wire_cost_mm': 228496.82440525628,
                        'radix': 8,
                        'diameter': 5,
                        'avg_hops': 2.5629432624113475,
                        'n_links': 147,
                        'max_link_mm': 19.570794258296317,
                        'sim_saturation': 0.5716875,
                        'latency_at_sat_ns': 42.77806931234284}}],
 'front': ['mesh',
           'hexamesh',
           'octamesh',
           'honeycomb_mesh',
           'fm_grid_diag_fpp~5974~461c',
           'fm_grid_diag_fpp~070e~9233',
           'fm_grid_diag_fpp~5974',
           'fm_grid_diag_fpp~5974~895d',
           'fm_grid_diag_fpp~ff2a',
           'fm_grid_diag_fpp~ff2a~9853',
           'rg_grid_22b18bf1~aa86~7481'],
 'front_eps': ['mesh',
               'hexamesh',
               'folded_hexa_torus',
               'octamesh',
               'honeycomb_mesh',
               'fm_grid_diag_fpp~5974~461c',
               'fm_grid_diag_fpp~934e',
               'fm_grid_diag_fpp~070e~9233',
               'fm_grid_diag_fpp~5974',
               'fm_grid_diag_fpp~5974~895d',
               'fm_grid_diag_fpp~ff2a',
               'fm_grid_diag_fpp~ff2a~9853',
               'rg_grid_22b18bf1~aa86~7481'],
 'fht_on_front': True,
 'prefilter_ratio': 6.1875,
 'rows_csv': '30638996691065e3893464278f153c4567e5082916152ae34ad4692f1e327d50',
 'buckets': [[48, 4, 192, 12],
             [48, 6, 256, 12],
             [48, 6, 288, 12],
             [48, 8, 320, 12],
             [48, 3, 128, 12]]}
# The `analysis` phase: `python -m repro_torch.analysis --all-builtin
# --hazards` (DEFAULT_N = 36, both substrates) and `analyze(names=
# ["folded_hexa_torus"], n=36, fault_kmax=2)`.  REFERENCE_ANALYSIS is
# `tools/smoke_reference.py analysis` (`python -m repro.analysis
# --all-builtin --jax` and `repro.analysis.analyze`) through
# `analysis_table`.  JX004 / JX005 read the port's op log, not a jaxpr:
# they are held to `runner_hazards.INTENDED` instead.
ANALYSIS_OWN_CODES = ("JX004", "JX005")
REFERENCE_ANALYSIS = {'cli_rc': 0,
 'cli': [['DP006',
          'hypercube/n36',
          'hypercube does not support N=36 (topology.N_CONSTRAINTS)'],
         ['DP001',
          'butterdonut/n36/organic',
          'link-range 2 > 1 (Principle 2)'],
         ['DP001', 'butterdonut/n36/glass', 'link-range 2 > 1 (Principle 2)'],
         ['DP001',
          'cluscross_v1/n36/organic',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001',
          'cluscross_v1/n36/glass',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001',
          'cluscross_v2/n36/organic',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001',
          'cluscross_v2/n36/glass',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001',
          'double_butterfly/n36/organic',
          'link-range 2 > 1 (Principle 2)'],
         ['DP001',
          'double_butterfly/n36/glass',
          'link-range 2 > 1 (Principle 2)'],
         ['DP001',
          'flattened_butterfly/n36/organic',
          'link-range 4 > 1 (Principle 2)'],
         ['DP003',
          'flattened_butterfly/n36/organic',
          'radix 10 > 8 (Principle 3)'],
         ['DP001',
          'flattened_butterfly/n36/glass',
          'link-range 4 > 1 (Principle 2)'],
         ['DP003',
          'flattened_butterfly/n36/glass',
          'radix 10 > 8 (Principle 3)'],
         ['DP001',
          'folded_octa_torus/n36/organic',
          'link-range 2 > 1 (Principle 2)'],
         ['DP001',
          'folded_octa_torus/n36/glass',
          'link-range 2 > 1 (Principle 2)'],
         ['DP001',
          'honeycomb_torus/n36/organic',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001',
          'honeycomb_torus/n36/glass',
          'link-range 4 > 1 (Principle 2)'],
         ['DP001', 'hypercube/n32/organic', 'link-range 6 > 1 (Principle 2)'],
         ['DP002',
          'hypercube/n32/organic',
          'max link 61.3 mm > 50.0 mm (organic rate floor 0.25)'],
         ['DP001', 'hypercube/n32/glass', 'link-range 6 > 1 (Principle 2)'],
         ['DP002',
          'hypercube/n32/glass',
          'max link 60.9 mm > 60.0 mm (glass rate floor 0.25)'],
         ['DP001', 'torus/n36/organic', 'link-range 4 > 1 (Principle 2)'],
         ['DP001', 'torus/n36/glass', 'link-range 4 > 1 (Principle 2)'],
         ['JX003',
          'batch[19]',
          '19 spec(s) span 16 distinct padded shapes -> 16 compiled '
          'executables; shape bucketing would reduce this to 1'],
         ['JX003',
          'batch[19]',
          '19 spec(s) span 16 distinct padded shapes -> 16 compiled '
          'executables; shape bucketing would reduce this to 1']],
 'cli_analyzed': '51aa3f29b7471cd2507263facc2746f74426ea16769d3cef13dda6e978df0ad8',
 'fht': [],
 'fht_analyzed': [['principles', 'folded_hexa_torus/n36/organic'],
                  ['routing', 'folded_hexa_torus/n36/organic[pristine]'],
                  ['routing', 'folded_hexa_torus/n36/organic[random:k1:s0]'],
                  ['routing', 'folded_hexa_torus/n36/organic[random:k2:s0]'],
                  ['principles', 'folded_hexa_torus/n36/glass'],
                  ['routing', 'folded_hexa_torus/n36/glass[pristine]'],
                  ['routing', 'folded_hexa_torus/n36/glass[random:k1:s0]'],
                  ['routing', 'folded_hexa_torus/n36/glass[random:k2:s0]']]}
# the workload batch of tests/test_torch_workloads.py
WL_HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("octamesh", 25)]
WL_RATES = [0.05, 0.2, 0.5]
WL_K_PAD = 6
WL_RAW = ("delivered_ph", "offered_ph", "accepted_ph", "lat_sum_ph")
HETERO = [("mesh", 16), ("folded_hexa_torus", 36), ("honeycomb_mesh", 16),
          ("octamesh", 25)]
HETERO_RATES = [0.05, 0.15, 0.3, 0.6]
RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# float32 rate outside the tensor cores, the closest listed rate for the
# kernel's 32-bit integer compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
TIMING_SAMPLES = 60
LAUNCHES_PER_SAMPLE = 20
PROFILE_CYCLES = 100
MODE_TIMED_CYCLES = 100
# netstep's warp layouts (R = 32 // PI routers per warp) and load widths
# (V in {1, 2, 4, 8} vector loads, V = 3 the generic kernel), held against
# the plain version on rows of LANE_N routers, no multiple of any R > 1
LANE_PIS = (1, 2, 4, 5, 7, 8, 9, 11, 15, 16, 17, 31, 32)
LANE_VS = (1, 2, 3, 4, 8)
LANE_N = 13
# one router per row (the row is the router) and long rows (the row by a
# multiply-high), each row its own rr pair
ROW_SHAPES = ((40, 1, 7, 4), (9, 1, 2, 3), (7, 1000, 5, 4), (3, 4099, 31, 2))
NETSTEP_PROFILED_CALLS = 50
# cycles of the fused cycle kernels held against their plain versions
# one by one from a loaded network, and the plain versions' timing
CYCLE_CHECKS = 8
PLAIN_CYCLE_SAMPLES = 5
PLAIN_CYCLE_REPS = 4

# The LM serving path (qwen3-1.7b and gemma3-1b: flash attention,
# mamba2-1.3b: SSD scan).  Peak rates of the H100 SXM data sheet by input
# type: the tensor cores' dense bf16 rate, and float32 outside the tensor
# cores.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SERVE = dict(batch=4, prompt=1024, gen=32)
# gemma3-1b serves a 2048-token prompt: its local layers' 1024 window then
# masks keys in prefill, and their ring caches wrap in decode
SERVE_PROMPT = {"gemma3-1b": 2048}
SERVE_LAUNCHES = {"qwen3-1.7b": ("flash_attention", 28),
                  "gemma3-1b": ("flash_attention", 26),
                  "mamba2-1.3b": ("ssd_scan", 48)}
SERVE_TOL = 0.08            # tests/test_integration.py's kernel tolerance
# bf16 serving through the kernels may sit no further from the f32
# logits than the plain bf16 path, give or take this factor (the max and
# mean over 4 x vocab logits move by a few % between two bf16 roundings)
BF16_MARGIN = 1.1
CARD_VS_CPU = dict(depth=2, batch=1, prompt=256, decode=4, tol=1e-3)
# the cases of tests/test_torch_cuda.py: (tq, tk, causal, window) x hd at
# batch 2, 4 q heads over 2 kv heads; SSD (b, t, h, p, n, chunk) for both
# routes, and the shapes only the bf16 route takes (any chunk)
FLASH_CASES = [(128, 128, True, None), (256, 256, True, None),
               (128, 256, False, None), (256, 256, True, 128),
               (128, 128, True, 64)]
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
SSD_CASES = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32),
             (3, 32, 8, 4, 4, 8), (1, 512, 4, 64, 128, 256)]
SSD_BF16_CASES = [(1, 96, 2, 8, 8, 48), (2, 16, 4, 16, 16, 8),
                  (2, 40, 3, 12, 20, 20), (1, 320, 2, 72, 136, 160)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
F32_MARGIN = 2.0            # f32 SSD at the path shape, against f64
FLASH_PATH = dict(b=4, t=1024, h=16, kv=8, hd=128)          # qwen3-1.7b
# gemma3-1b's prefill: 4 q heads over 1 kv head of 256, window 1024 on
# five of every six layers; and the hd 256 cases beside it (GQA 4:1,
# causal): (tq, tk) x window.  Tq <= Tk, so that every query row sees a
# key (a row that sees none has no defined attention: the plain version
# spreads it over all keys, the kernels over the tiles they visit)
GEMMA_PATH = dict(b=4, t=2048, h=4, kv=1, hd=256, window=1024)
HD256_CASES = [(tq, tk, window) for tq, tk in ((2048, 2048), (128, 256))
               for window in (None, 1024, 96)]
SSD_PATH = dict(b=4, t=1024, h=64, p=64, n=128, chunk=256)  # mamba2-1.3b
ROUTE = {"bfloat16": "bf16", "float32": "f32"}
LM_TIMING_SAMPLES = 10
DECODE_PROFILE_STEPS = 8

# The LM training path (qwen3-1.7b).  (a) the smoke config at float32
# compute through the train driver's loop (`launch.train.run`), its
# parameters drawn by `train_smoke_params`, held to REFERENCE_TRAIN
# (tools/smoke_reference.py train: the JAX package's train step on the
# CPU) at tests/test_torch_train.py's float32 tolerance; (b) full width at
# depth 2, float32, one step on the card against the same step on the CPU;
# (c) full width and depth, bf16, remat "full" at the serving cell's
# prompt length: the driver's 10 steps, then 12 steps on one batch
# (tests/test_models.py::test_loss_decreases), then single steps of each
# remat mode at batch 1 for their peak memory.
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_SMOKE = dict(steps=8, batch=4, seq=32, ckpt_every=4, seed=0)
TRAIN_TOL = 1e-4
TRAIN_WIDE = dict(depth=2, batch=2, seq=128, warmup=1, tol=1e-4)
TRAIN_FULL = dict(batch=4, seq=1024, steps=10, warm_steps=2,
                  descent_steps=12, descent_warmup=2, min_fall=0.5,
                  f32_loss_tol=0.02, remat_batch=1, profile_steps=2,
                  opt_samples=5)
REFERENCE_TRAIN = {
    'loss': [
        6.245683193206787, 6.2393317222595215, 6.277894973754883,
        6.258502960205078, 6.264058589935303, 6.263114929199219,
        6.261895656585693, 6.237666130065918],
    'grad_norm': [
        1.5078481435775757, 1.4674230813980103, 1.4848532676696777,
        1.5038626194000244, 1.4620689153671265, 1.4820626974105835,
        1.4910411834716797, 1.4698314666748047],
    'loss_mb2': [
        6.245683193206787, 6.2393317222595215, 6.277894973754883,
        6.258502960205078, 6.264059066772461, 6.263114929199219,
        6.261896133422852, 6.23766565322876],
    'grad_norm_mb2': [
        1.5078482627868652, 1.4674230813980103, 1.4848532676696777,
        1.5038626194000244, 1.4620689153671265, 1.482062578201294,
        1.4910411834716797, 1.4698314666748047]}


# The model families: MLA (minicpm3-4b), the encoder-decoder
# (seamless-m4t-medium), MoE (qwen3-moe-235b-a22b; grok-1-314b, whose
# experts are split into 2 virtual experts each, in the parity run only:
# 4.9 B parameters per layer at full width) and the attention:SSM:MoE
# hybrid (jamba-v0.1-52b).  (a) the smoke configs at float32 compute from
# `train_smoke_params`, held to REFERENCE_FAMILIES (tools/smoke_reference.py
# families: the JAX package on the CPU); (b) serving at full width, bf16,
# the serving cell's batch 4 x prompt 1024 x 32 new tokens, each config
# cut in depth to what the card holds (f32 masters + a bf16 copy):
# jamba's 5 layers are 4 Mamba2 layers and 1 attention layer, 2 of them
# MoE (8 layers, one whole pattern period, need about 76 GB), qwen3-moe
# keeps 2 of 94; (c) the grouped MoE product against its per-expert loop
# on the card.
FAMILY_ARCHS = ("minicpm3-4b", "seamless-m4t-medium", "qwen3-moe-235b-a22b",
                "grok-1-314b", "jamba-v0.1-52b")
FAMILIES_SMOKE = dict(batch=2, prompt=16, decode=2, seed=0, train_batch=2,
                      train_seq=16)
FAMILIES_TOL = 1e-4
FAMILIES_HEAD = 8
FAMILY_SERVE_DEPTH = {"minicpm3-4b": None, "seamless-m4t-medium": None,
                      "jamba-v0.1-52b": 5, "qwen3-moe-235b-a22b": 2}
# (flash, SSD) launches per prefill
FAMILY_LAUNCHES = {"minicpm3-4b": (0, 0), "seamless-m4t-medium": (12, 0),
                   "jamba-v0.1-52b": (1, 4), "qwen3-moe-235b-a22b": (2, 0)}
# kernel against plain at f32: depth 2, but jamba 5 (layer 4 is its first
# attention layer); the card against the CPU at depth 2
FAMILY_KVP_DEPTH = {"jamba-v0.1-52b": 5}
FAMILY_CARD_VS_CPU = ("minicpm3-4b", "seamless-m4t-medium")
MOE_CHECK = ("qwen3-moe-235b-a22b", "jamba-v0.1-52b")
MOE_TOL = 2e-2              # bf16 products rounded in other orders
# the flash and SSD shapes of these paths' prefills
FAMILY_FLASH = {
    "seamless-m4t-medium": dict(b=4, t=1024, h=16, kv=16, hd=64),
    "jamba-v0.1-52b": dict(b=4, t=1024, h=32, kv=8, hd=128),
    "qwen3-moe-235b-a22b": dict(b=4, t=1024, h=64, kv=4, hd=128)}
FAMILY_SSD = {"jamba-v0.1-52b": dict(b=4, t=1024, h=128, p=64, n=64,
                                     chunk=256)}
# The sharded paths (launch.mesh, launch.steps, Model(cfg, ctx)) on a 1 x 1
# NCCL mesh: qwen3-moe served as families_serve serves it; at capacity
# factor 16 = n_experts / top_k each expert takes every token (nothing is
# dropped), so it is held to the unsharded (dropless) model: in f32 at
# CARD_VS_CPU's tolerance with equal greedy tokens, in bf16 one MoE layer
# on one input at MOE_TOL and the whole model's mean distance from the f32
# logits at most 1.1 x the unsharded bf16 model's (the families phase's
# kernel-vs-plain ratio); the config's own 1.25 is timed and its drops
# counted.
SHARDED = dict(arch="qwen3-moe-235b-a22b", depth=2, dropless_cf=16.0,
               flash=2, drop_decode_steps=4, bf16_mean_ratio=1.1)
# decode_attention_dist at qwen3-1.7b's decode shape (q [4, 1, 16, 128],
# cache [4, 1056, 8, 128], f32) at the reference test's tolerance
DIST_DECODE = dict(b=4, s=1056, h=16, kv=8, hd=128, pos=1040, tol=2e-5)
# sequence parallelism forced on, and the elastic restore: qwen3-1.7b at
# full width, depth 2, f32, batch 4 x prompt 1024
SEQ_PARALLEL = dict(arch="qwen3-1.7b", depth=2, batch=4, prompt=1024,
                    tol=1e-3)
# The sharded train step (`launch.steps.make_train_step` and
# `launch.train.run` on `Model(cfg, ctx)`) on a 1 x 1 NCCL mesh, from
# TRAIN_FULL's batch and seed: (a) qwen3-1.7b at full width, depth 2, f32,
# three steps against the unsharded step from the same parameters (loss,
# grad norm, every parameter, m and v after each step, relative to each
# leaf's largest magnitude); (b) full depth, bf16, remat "full", the
# driver's 10 steps against the unsharded `train_full` losses, saving
# after step 5; (c) one qwen3-moe MoE layer at full width, f32, at capacity
# factor 16 (nothing dropped): the gradients of the input and of every
# expert weight through both expert-parallel bodies against the dropless
# loop route; (d) (b)'s step-5 checkpoint restored unsharded takes step 6
# as (b) did, bit for bit.
SHARDED_TRAIN = dict(depth=2, steps=3, tol=1e-5, full_tol=1e-3, ckpt_every=5,
                     moe_arch="qwen3-moe-235b-a22b", moe_cf=16.0, moe_tol=1e-4,
                     profile_steps=2)
REFERENCE_FAMILIES = {
    'minicpm3-4b':
        {'prefill': {'head': [[0.1623096466064453,
                               -0.04943545535206795,
                               -0.08100353181362152,
                               -0.16588592529296875,
                               0.12111146748065948,
                               -0.35607704520225525,
                               -0.1940605640411377,
                               -0.01270329114049673],
                              [0.07181066274642944,
                               -0.024260643869638443,
                               -0.048082489520311356,
                               0.14603473246097565,
                               -0.20927958190441132,
                               -0.16604314744472504,
                               -0.13737590610980988,
                               -0.09356516599655151]],
                     'sum': [6.335153372725472, 6.58399384166114],
                     'abs_sum': [65.67437023489038, 65.5315780097153],
                     'max': [1.215112566947937, 1.352096438407898]},
         'decode': [{'head': [[-0.0936628058552742,
                               0.34712862968444824,
                               -0.174148827791214,
                               -0.018592234700918198,
                               0.1242402121424675,
                               0.1218176931142807,
                               -0.2223278284072876,
                               0.04258544370532036],
                              [0.18959827721118927,
                               0.06069927290081978,
                               -0.13581673800945282,
                               0.07730796188116074,
                               0.09065781533718109,
                               0.11468726396560669,
                               -0.1331043243408203,
                               -0.06189596652984619]],
                     'sum': [3.7910230167908594, 8.488647608572137],
                     'abs_sum': [62.296120675397106, 63.917449321577806],
                     'max': [1.350468635559082, 1.099976897239685]},
                    {'head': [[0.017931083217263222,
                               0.0050426810048520565,
                               0.10584212094545364,
                               -0.32712364196777344,
                               -0.463600754737854,
                               -0.02635965123772621,
                               -0.1718982458114624,
                               0.17518696188926697],
                              [-0.017053110525012016,
                               0.05536561831831932,
                               0.30620118975639343,
                               0.25902390480041504,
                               -0.15755081176757812,
                               0.194308340549469,
                               0.12281142175197601,
                               0.19995425641536713]],
                     'sum': [2.9159077685944794, -4.965547331026755],
                     'abs_sum': [70.31480887060388, 67.22712702897843],
                     'max': [1.1140518188476562, 1.1935704946517944]}],
         'loss': 6.172346115112305,
         'grad_norm': 2.2889413833618164},
    'seamless-m4t-medium':
        {'prefill': {'head': [[0.07004502415657043,
                               0.025750968605279922,
                               -0.07417437434196472,
                               -0.18386466801166534,
                               0.09997491538524628,
                               -0.29207345843315125,
                               -0.11408521234989166,
                               -0.10516253113746643],
                              [0.19397836923599243,
                               0.17492753267288208,
                               -0.12432996928691864,
                               0.1655033677816391,
                               -0.09822895377874374,
                               -0.20555590093135834,
                               -0.1913744956254959,
                               0.13323450088500977]],
                     'sum': [7.683943076757714, 2.2527788166771643],
                     'abs_sum': [65.22186790104024, 66.92427532852162],
                     'max': [1.0653066635131836, 0.988971471786499]},
         'decode': [{'head': [[-0.11070426553487778,
                               -0.13882306218147278,
                               0.2596428394317627,
                               -0.26200976967811584,
                               -0.21076415479183197,
                               -0.18616077303886414,
                               0.012198777869343758,
                               0.02750569023191929],
                              [0.08303196728229523,
                               0.3296467661857605,
                               -0.14319832623004913,
                               0.13798950612545013,
                               0.029784006997942924,
                               -0.0374968983232975,
                               -0.32241538166999817,
                               0.030924508348107338]],
                     'sum': [6.057913425334846, -1.5077938848698977],
                     'abs_sum': [69.86366918515705, 64.06397058113362],
                     'max': [0.8696767091751099, 0.8352431654930115]},
                    {'head': [[-0.11022458225488663,
                               -0.11310328543186188,
                               -0.15529175102710724,
                               -0.16846878826618195,
                               -0.2054620385169983,
                               -0.23595963418483734,
                               -0.020143598318099976,
                               0.00238221138715744],
                              [0.1836257427930832,
                               0.26531869173049927,
                               -0.2604266405105591,
                               -0.027208484709262848,
                               0.08576526492834091,
                               -0.19060491025447845,
                               -0.11860378831624985,
                               0.05268789455294609]],
                     'sum': [5.362653938878793, -0.3949626889079809],
                     'abs_sum': [65.0645319338073, 66.14492868166417],
                     'max': [0.8034852147102356, 0.7777954936027527]}],
         'loss': 6.179931640625,
         'grad_norm': 2.8720407485961914},
    'qwen3-moe-235b-a22b':
        {'prefill': {'head': [[0.24926051497459412,
                               0.08506728708744049,
                               -0.11284121870994568,
                               -0.03934646025300026,
                               0.2222362756729126,
                               -0.3594242334365845,
                               -0.20787116885185242,
                               -0.08221644163131714],
                              [0.0301729254424572,
                               -0.1307680904865265,
                               0.09287384152412415,
                               0.27797555923461914,
                               -0.18169903755187988,
                               -0.04878837615251541,
                               -0.11076118797063828,
                               -0.05809943377971649]],
                     'sum': [3.122122883789416, 4.688752544840099],
                     'abs_sum': [64.76635296946188, 67.00608529543388],
                     'max': [1.0501317977905273, 1.2211227416992188]},
         'decode': [{'head': [[0.061707496643066406,
                               0.35704562067985535,
                               -0.28936535120010376,
                               0.004418205004185438,
                               0.026693392544984818,
                               0.14289817214012146,
                               -0.2072833776473999,
                               0.04776633530855179],
                              [-0.059969786554574966,
                               0.22390756011009216,
                               -0.2948465943336487,
                               0.22247299551963806,
                               -0.02968580275774002,
                               0.2086603045463562,
                               -0.09748882055282593,
                               -0.11303015053272247]],
                     'sum': [0.010982174630044028, 3.351911379984813],
                     'abs_sum': [63.304712003533496, 64.73713668072014],
                     'max': [1.0602304935455322, 0.9463136792182922]},
                    {'head': [[0.1292356550693512,
                               -0.04765050485730171,
                               0.0892544537782669,
                               -0.17814317345619202,
                               -0.4572117328643799,
                               0.11164446175098419,
                               -0.26736345887184143,
                               0.15099981427192688],
                              [-0.13382016122341156,
                               0.0005842061946168542,
                               0.3824126422405243,
                               0.2769051790237427,
                               -0.06283720582723618,
                               0.21821394562721252,
                               0.14703139662742615,
                               0.07782191038131714]],
                     'sum': [-0.34657375048846006, -2.9324181096872053],
                     'abs_sum': [69.9558152022073, 66.94570010034477],
                     'max': [0.9058383107185364, 1.0058051347732544]}],
         'loss': 6.198937892913818,
         'grad_norm': 2.96852707862854},
    'grok-1-314b':
        {'prefill': {'head': [[0.2032388597726822,
                               0.08922099322080612,
                               -0.08407722413539886,
                               -0.034094251692295074,
                               0.2089749276638031,
                               -0.26459982991218567,
                               -0.20543614029884338,
                               -0.049669042229652405],
                              [-0.013438818976283073,
                               -0.14390763640403748,
                               0.11994759738445282,
                               0.2178184688091278,
                               -0.10424140095710754,
                               -0.1336423009634018,
                               -0.1252194494009018,
                               -0.15347257256507874]],
                     'sum': [3.048303491261322, 7.130332627326425],
                     'abs_sum': [66.53407118603354, 65.79146782056341],
                     'max': [1.0923796892166138, 1.273187279701233]},
         'decode': [{'head': [[-0.048415981233119965,
                               0.3875940144062042,
                               -0.22783081233501434,
                               0.03165116906166077,
                               0.1562480330467224,
                               0.20379270613193512,
                               -0.24109280109405518,
                               -0.032688938081264496],
                              [0.13375462591648102,
                               0.005320177413523197,
                               -0.08321723341941833,
                               0.19530662894248962,
                               0.06150240823626518,
                               0.16618452966213226,
                               -0.0813065618276596,
                               -0.14705508947372437]],
                     'sum': [0.004551695616100915, 6.701755250978749],
                     'abs_sum': [63.224099810715416, 63.62217580358265],
                     'max': [1.1899032592773438, 1.0330735445022583]},
                    {'head': [[0.061016011983156204,
                               0.02500269189476967,
                               0.014671610668301582,
                               -0.18928714096546173,
                               -0.4475666880607605,
                               0.06678254902362823,
                               -0.26428791880607605,
                               0.05340243875980377],
                              [-0.05919428542256355,
                               -0.03102749027311802,
                               0.30079108476638794,
                               0.3679768741130829,
                               -0.13284119963645935,
                               0.23467114567756653,
                               0.17864178121089935,
                               0.11189600825309753]],
                     'sum': [-1.2695380016089075, -4.014320710186439],
                     'abs_sum': [69.87269001463619, 67.60125657058234],
                     'max': [0.9608517289161682, 1.1322003602981567]}],
         'loss': 6.193070888519287,
         'grad_norm': 2.6444520950317383},
    'jamba-v0.1-52b':
        {'prefill': {'head': [[0.07409341633319855,
                               0.001952502760104835,
                               -0.13105395436286926,
                               -0.19942337274551392,
                               -0.13624051213264465,
                               0.023907767608761787,
                               -0.11624119430780411,
                               -0.055616457015275955],
                              [-0.1502171754837036,
                               -0.1599920243024826,
                               -0.0747489333152771,
                               -0.008829333819448948,
                               -0.047562260180711746,
                               0.1517593264579773,
                               -0.3739506006240845,
                               0.13449136912822723]],
                     'sum': [4.835651356494054, 1.2953246826509712],
                     'abs_sum': [68.87501890072599, 62.283640997178736],
                     'max': [0.49150753021240234, 0.5828625559806824]},
         'decode': [{'head': [[-0.08145534247159958,
                               0.054121825844049454,
                               0.01662319153547287,
                               0.18891294300556183,
                               -0.2014985978603363,
                               0.08276699483394623,
                               0.11628150194883347,
                               0.1430182307958603],
                              [-0.0651538223028183,
                               0.17340531945228577,
                               -0.02440999448299408,
                               -0.1413477659225464,
                               -0.234419584274292,
                               -0.0006925914203748107,
                               -0.1646178662776947,
                               0.009716336615383625]],
                     'sum': [-7.61080747959204, -2.160195825606934],
                     'abs_sum': [65.46310648182407, 65.10147615252936],
                     'max': [0.4969758093357086, 0.4819447696208954]},
                    {'head': [[-0.11747381091117859,
                               0.04200834035873413,
                               -0.13445666432380676,
                               -0.09136826545000076,
                               0.2959202229976654,
                               -0.2539481520652771,
                               -0.06791625916957855,
                               0.039884619414806366],
                              [0.08811837434768677,
                               -0.10272341966629028,
                               0.0988563522696495,
                               -0.17500334978103638,
                               -0.12901033461093903,
                               0.240894615650177,
                               0.2303541600704193,
                               0.019478779286146164]],
                     'sum': [6.409685641629039, 3.0265867710259045],
                     'abs_sum': [69.12388154504879, 69.06264672645193],
                     'max': [0.4312598407268524, 0.4683970510959625]}],
         'loss': 6.268673896789551,
         'grad_norm': 3.4270384311676025},
}

# The nine scripts of examples_torch/, each called in-process through its
# main(argv) with no --device (the card by default).  The six simulator
# examples run at the reference examples' own sizes: {script: the files
# it writes under --out}.  Their files' SHA-256 and their printed result
# lines (`example_lines`) equal REFERENCE_EXAMPLES, the reference scripts'
# (`tools/smoke_reference.py examples`: examples/, unedited, on a CPU).
SIM_EXAMPLES = {
    "quickstart": ("quickstart.csv",),
    "workload_quickstart": ("workload_quickstart.csv",),
    "fault_quickstart": ("fault_quickstart.csv",),
    "obs_quickstart": ("obs_quickstart_links.csv",
                       "obs_quickstart_windows.csv"),
    "adaptive_quickstart": (),
    "synth_quickstart": ("synth_state_demo.json",)}
# serve_lm and train_lm at full width and depth, bf16; topology_collectives
# on the record of `python -m repro_torch.launch.dryrun` with these flags
EXAMPLE_SERVE = ["--arch", "qwen3-1.7b", "--batch", str(SERVE["batch"]),
                 "--prompt-len", str(SERVE["prompt"]), "--gen",
                 str(SERVE["gen"])]
# 20 steps: the driver warms the rate up over its first 5 (at 5 steps the
# losses moved by noise alone on the card: 12.3466 ... 12.3475)
EXAMPLE_TRAIN_STEPS = 20
EXAMPLE_TRAIN = ["--arch", TRAIN_ARCH, "--batch", "4", "--seq", "1024",
                 "--steps", str(EXAMPLE_TRAIN_STEPS), "--log-every", "1"]
EXAMPLE_DRYRUN = ["--arch", "qwen3-1.7b", "--shape", "train_4k",
                  "--microbatches", "1"]
ICI_PRICED = ("mesh", "hexamesh", "folded_torus", "folded_hexa_torus")
REFERENCE_EXAMPLES = {'files': {'quickstart.csv': 'eefde8dd723d4dcc4befe0bca1b105045605c2655654f7156757c46852b2349a',
           'workload_quickstart.csv': 'a0b7eb44222ea7d218265ea1e735859946d79ef2767164bfa0339916d4aeb2b0',
           'fault_quickstart.csv': '325008db6ce7670a7dba419d908c950f34948b93fd4a7b8b066b3ae2b17a18a6',
           'obs_quickstart_links.csv': '6aa766bbeeb413fb2d20359d038af5831ea8aaaeec23dc0a8de40a9919432bda',
           'obs_quickstart_windows.csv': 'f988010837155969e3464a4b83731748afb0daa58357101e13a3c3ce0bd8dff1',
           'synth_state_demo.json': 'f307338d6d3c5ed7cf9a95b4f0924d15e7afd82a404d4042253ce1e6e8b5e094'},
 'lines': {'quickstart': ['=== the core layer: one topology, routed and '
                          'checked ===',
                          'folded_hexa_torus    diam= 6 radix=6 maxlink= '
                          '19.6mm analytic T_r=0.508',
                          '',
                          '=== the experiment API: a grid through one front '
                          'door ===',
                          'mesh                 T_r=0.108 flits/node/cyc  '
                          'T_a=   0.33 Tb/s  lat= 42.7ns',
                          'hexamesh             T_r=0.414 flits/node/cyc  '
                          'T_a=   0.83 Tb/s  lat= 34.6ns',
                          'folded_torus         T_r=0.147 flits/node/cyc  '
                          'T_a=   0.44 Tb/s  lat= 36.6ns',
                          'folded_hexa_torus    T_r=0.508 flits/node/cyc  '
                          'T_a=   0.96 Tb/s  lat= 26.1ns',
                          '',
                          '=== cycle-accurate check (16 chiplets, simulated) '
                          '===',
                          'simulated saturation 0.786 (analytic bound 1.000), '
                          'latency@sat 29.5 cycles'],
           'workload_quickstart': ['=== workloads x topologies, one '
                                   'declarative experiment ===',
                                   'mesh               '
                                   'collective:qwen3-1.7b    sat=0.752 lat= '
                                   '21.8cy  per-phase [fsdp_gather=0.334, '
                                   'fwd_tp=0.815, bwd_tp=0.865, '
                                   'grad_reduce=0.514]',
                                   'mesh               '
                                   'trace:fluidanimate       sat=0.229 lat= '
                                   '52.2cy  per-phase [region0=0.231, '
                                   'region1=0.233, region2=0.233, '
                                   'region3=0.224, region4=0.221]',
                                   'mesh               '
                                   'alt:tornado-uniform      sat=0.433 lat= '
                                   '64.7cy  per-phase [tornado=0.430, '
                                   'uniform=0.435, tornado=0.412, '
                                   'uniform=0.453]',
                                   'folded_hexa_torus  '
                                   'collective:qwen3-1.7b    sat=0.752 lat= '
                                   '21.8cy  per-phase [fsdp_gather=0.304, '
                                   'fwd_tp=0.814, bwd_tp=0.865, '
                                   'grad_reduce=0.544]',
                                   'folded_hexa_torus  '
                                   'trace:fluidanimate       sat=0.249 lat= '
                                   '27.7cy  per-phase [region0=0.250, '
                                   'region1=0.250, region2=0.247, '
                                   'region3=0.250, region4=0.251]',
                                   'folded_hexa_torus  '
                                   'alt:tornado-uniform      sat=0.669 lat= '
                                   '34.3cy  per-phase [tornado=0.578, '
                                   'uniform=0.755, tornado=0.568, '
                                   'uniform=0.776]',
                                   '',
                                   '=== anatomy of the collective schedule on '
                                   'FHT-16 ===',
                                   '  fsdp_gather   106cy intensity=0.287 '
                                   'peak-row=2.54e+08 bytes',
                                   '  fwd_tp        394cy intensity=1.000 '
                                   'peak-row=3.29e+09 bytes',
                                   '  bwd_tp        394cy intensity=1.000 '
                                   'peak-row=3.29e+09 bytes',
                                   '  grad_reduce   106cy intensity=0.287 '
                                   'peak-row=2.54e+08 bytes'],
           'fault_quickstart': ['=== uniform-traffic degradation, N=36 '
                                'organic ===',
                                '  mesh               k=0 '
                                'faults=none             sat=0.161 abs=0.50 '
                                'Tb/s',
                                '  mesh               k=1 '
                                'faults=rand:k1:s0       sat=0.147 abs=0.46 '
                                'Tb/s',
                                '  mesh               k=2 '
                                'faults=rand:k2:s0       sat=0.131 abs=0.41 '
                                'Tb/s',
                                '  mesh               k=4 '
                                'faults=rand:k4:s0       sat=0.153 abs=0.47 '
                                'Tb/s',
                                '  folded_hexa_torus  k=0 '
                                'faults=none             sat=0.509 abs=0.96 '
                                'Tb/s',
                                '  folded_hexa_torus  k=1 '
                                'faults=rand:k1:s0       sat=0.589 abs=1.12 '
                                'Tb/s',
                                '  folded_hexa_torus  k=2 '
                                'faults=rand:k2:s0       sat=0.456 abs=0.86 '
                                'Tb/s',
                                '  folded_hexa_torus  k=4 '
                                'faults=rand:k4:s0       sat=0.505 abs=0.96 '
                                'Tb/s',
                                '',
                                '=== mixed tenant (train collectives + 30% '
                                'serving) through the same masks ===',
                                '  k=0 sat=0.572 lat=42.3cy (4 phases)',
                                '  k=2 sat=0.486 lat=44.5cy (4 phases)',
                                '',
                                '=== partitioned packages are outages, not '
                                'data points ===',
                                '  rejected: mesh[L0-1,0-4]: fault set '
                                'disconnects the surviving chiplets into 2 '
                                'islands of sizes [15, 1]; a partitioned '
                                'package cannot serve traffic — choose a '
                                'survivable fault set (see '
                                'faults.sample_faults(..., '
                                'require_connected=True))'],
           'obs_quickstart': ['=== 1. per-link load at saturation (the '
                              "paper's mechanism) ===",
                              '  mesh               links= 48 p50=0.254 '
                              'p95=0.693 max=0.830 gini=0.368',
                              '  folded_hexa_torus  links= 88 p50=0.217 '
                              'p95=0.514 max=0.710 gini=0.284',
                              '  -> folding flattens the load: FHT gini 0.284 '
                              'vs mesh 0.368',
                              '',
                              '=== 2. conservation: flight counters == '
                              'aggregate counters ===',
                              '  mesh               sum(inj)==accepted, '
                              'sum(eject)==delivered, sum(hist)==delivered  '
                              '[exact]',
                              '  folded_hexa_torus  sum(inj)==accepted, '
                              'sum(eject)==delivered, sum(hist)==delivered  '
                              '[exact]',
                              '',
                              '=== 3. where the wall-clock went ===',
                              '  sweep runs=2',
                              '  open results/obs_quickstart.trace.json in '
                              'ui.perfetto.dev for the span tree',
                              '',
                              '=== 4. windowed time-heatmap: a hotspot '
                              'drifting across FHT36 ===',
                              '  per-window channel-load imbalance (gini) and '
                              'the escape/adaptive occupancy split:',
                              '  window 0 [t=   0.. 100) util_p95=0.286 '
                              'gini=0.628 occ_esc=0.876 occ_adapt=2.293',
                              '  window 1 [t= 100.. 200) util_p95=0.280 '
                              'gini=0.594 occ_esc=0.838 occ_adapt=2.201',
                              '  window 2 [t= 200.. 300) util_p95=0.320 '
                              'gini=0.581 occ_esc=0.681 occ_adapt=2.045',
                              '  window 3 [t= 300.. 400) util_p95=0.260 '
                              'gini=0.602 occ_esc=0.709 occ_adapt=1.953',
                              '  window 4 [t= 400.. 500) util_p95=0.277 '
                              'gini=0.617 occ_esc=0.738 occ_adapt=2.111',
                              '  window 5 [t= 500.. 600) util_p95=0.303 '
                              'gini=0.618 occ_esc=0.716 occ_adapt=2.265',
                              "  -> each window's hot channels move with the "
                              'hotspot; the aggregate heatmap above averages '
                              'this away'],
           'adaptive_quickstart': ['=== 1. productive ports + escape '
                                   'certification (RT005) ===',
                                   '  mask [N_dst, N, P] = (36, 36, 4), 1782 '
                                   'productive entries',
                                   '  certificate: ok=True escape_safe=True '
                                   'adaptive_choices=1782',
                                   '',
                                   '=== 2. static vs adaptive under a '
                                   'drifting hotspot ===',
                                   '  mesh36, hotspot_drift: static 0.089 '
                                   'adaptive 0.113  gain +27.5%',
                                   '',
                                   '=== 3. the same thing declaratively, via '
                                   'Scenario(routing) ===',
                                   '  folded_hexa_torus  routing=static   '
                                   'sim_saturation=0.121',
                                   '  folded_hexa_torus  routing=adaptive '
                                   'sim_saturation=0.134',
                                   "  -> FHT's static channel load is already "
                                   'flat, so its adaptive margin is small'],
           'synth_quickstart': ['=== custom topologies are first-class ===',
                                '  ring16             analytic T_r=0.263 '
                                'radix=2',
                                '  double_ring        analytic T_r=0.600 '
                                'radix=4',
                                '  folded_hexa_torus  analytic T_r=1.000 '
                                'radix=6',
                                '',
                                '=== the design space + feasibility filter '
                                '===',
                                '  36 fold-mask variants, 12 '
                                'substrate-feasible',
                                '  random geometric: rg_grid_00000007 radix=6 '
                                'links=44 feasible=True',
                                '',
                                '=== a small seeded search (save + resume) '
                                '===',
                                '  35 feasible candidates, 12 cycle-simulated '
                                '(prefilter 2.9x)',
                                '  front: hexamesh                  1465.1 '
                                'Gb/s   17.5 ns     42541 wire-mm',
                                '  front: folded_hexa_torus         1523.6 '
                                'Gb/s   13.9 ns     82402 wire-mm',
                                '  front: octamesh                  1151.1 '
                                'Gb/s   15.2 ns     44584 wire-mm',
                                '  front: fm_brick_fpp              1497.9 '
                                'Gb/s   16.0 ns     56930 wire-mm',
                                '  front: fm_brick_fpp~070e         1422.6 '
                                'Gb/s   16.1 ns     55590 wire-mm',
                                '  front: fm_brick_ffp              1502.4 '
                                'Gb/s   14.9 ns     68996 wire-mm',
                                '  front: folded_hexa_torus~aa86    1521.6 '
                                'Gb/s   14.1 ns     78663 wire-mm',
                                '  folded_hexa_torus within 5% of front: '
                                'True']}}


def family_inputs(cfg, fs=FAMILIES_SMOKE):
    """numpy (prompts [B, T] int64, frames [B, T, D] float32 for an
    encoder-decoder else None, decode tokens [steps, B, 1] int64) of the
    families' parity run, drawn in that order from one generator."""
    import numpy as np
    rng = np.random.default_rng(fs["seed"])
    b, t = fs["batch"], fs["prompt"]
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int64)
    frames = None
    if cfg.arch_kind == "encdec":
        frames = rng.normal(0, 0.02, (b, t, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (fs["decode"], b, 1)).astype(np.int64)
    return toks, frames, steps


def logits_summary(logits) -> dict:
    """Logits [B, V] as the parity table keeps them: each row's first
    FAMILIES_HEAD values, its sum, sum of magnitudes and maximum."""
    import numpy as np
    a = np.asarray(logits, np.float64)
    return dict(head=a[:, :FAMILIES_HEAD].tolist(), sum=a.sum(1).tolist(),
                abs_sum=np.abs(a).sum(1).tolist(), max=a.max(1).tolist())


def numbers(tree) -> list:
    """The numbers of a nested dict / list, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in numbers(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in numbers(v)]
    return [float(tree)]


def train_smoke_params(named_shapes, seed: int = 0) -> dict:
    """{parameter name: float32 array} for the training parity run: every
    matrix normal(0, 0.02), every vector 1 (the norms), each drawn from a
    generator seeded by (seed, crc32(name)), so both packages build the
    same parameters from the port's names (`layers.3.attn.wq`) and shapes
    whatever order they visit them in."""
    import zlib

    import numpy as np
    out = {}
    for name, shape in named_shapes:
        if len(shape) < 2:
            out[name] = np.ones(shape, np.float32)
        else:
            rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
            out[name] = rng.normal(0.0, 0.02, shape).astype(np.float32)
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wl_phases(i, u, t):
    """Schedule i of the workload batch (tests/test_torch_workloads.py):
    3, 4 and 2 phases of (traffic, intensity, duration[, on, off])."""
    return [
        [(u, 1.0, 70), (t, 0.8, 90, 10, 30), (u, 0.0, 40)],
        [(t, 1.3, 50, 5, 7), (u, 1.0, 100), (u, 0.0, 30),
         (t, 0.6, 120, 3, 1)],
        [(u, 0.7, 60, 20, 60), (t, 1.0, 40)],
    ][i]


def experiment_scenarios(X, W, F, T) -> list:
    """The `experiments` phase's 15 scenarios at N = 256, organic (also
    built by tools/smoke_reference.py with the JAX package)."""
    grid = X.SaturationGrid(EXP_RATES)
    workloads = [
        W.Workload("hotspot_drift",
                   lambda t: W.hotspot_drift(t, n_phases=6, dwell=200)),
        W.Workload("phase_alternating",
                   lambda t: W.phase_alternating(
                       t, ("tornado", "uniform"), phase_cycles=300,
                       repeats=2)),
        W.Workload("bursty_uniform",
                   lambda t: W.bursty_uniform(t, on=20, off=60)),
    ]
    out = [X.Scenario(name, MAIN_N, "organic", "uniform", area=74.0,
                      rates=grid)
           for name in PRINCIPLED]
    out += [X.Scenario(name, MAIN_N, "organic", wl, rates=grid)
            for name in ("mesh", "folded_hexa_torus") for wl in workloads]
    topo = T.build("folded_hexa_torus", MAIN_N, substrate="organic")
    fault_sets = [F.FaultSet()] + [F.sample_faults(topo, k, kind, seed=0)
                                   for k, kind in EXP_FAULTS]
    out += [X.Scenario("folded_hexa_torus", MAIN_N, "organic", "uniform",
                       faults=fs, rates=grid) for fs in fault_sets]
    return out


def adaptive_scenarios(X, W, n=MAIN_N, n_rates=EXP_RATES) -> list:
    """The `adaptive_telemetry` phase's 6 scenarios (also built by
    tools/smoke_reference.py with the JAX package): each of
    ADAPTIVE_TOPOLOGIES at `n`, organic, under hotspot_drift, static then
    adaptive."""
    grid = X.SaturationGrid(n_rates)
    drift = W.Workload("hotspot_drift",
                       lambda t: W.hotspot_drift(t, n_phases=6, dwell=200))
    return [X.Scenario(name, n, "organic", drift, rates=grid,
                       routing=routing)
            for name in ADAPTIVE_TOPOLOGIES
            for routing in ("static", "adaptive")]


def adaptive_cfg(SimConfig, cycles=EXP_CYCLES, warmup=EXP_WARMUP,
                 windows=ADAPTIVE_WINDOWS):
    return SimConfig(cycles=cycles, warmup=warmup, telemetry=True,
                     telemetry_windows=windows)


def digest(*arrays, dtype="int32") -> str:
    """SHA-256 of the arrays' bytes as `dtype`, in order."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, dtype).tobytes())
    return h.hexdigest()


def file_digest(path) -> str:
    """SHA-256 of a file's bytes."""
    import hashlib
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def example_lines(stdout: str, out: str | None = None) -> list:
    """The result lines an example prints, as the reference's and the
    port's are compared: the `[io] wrote` / `[obs] wrote` lines go (they
    name the files, which are compared by digest); in the port's lines
    (`out`: its --out directory) that directory reads `results/`, where
    the reference writes; the reference's pointer to
    `results/adaptive_gain.csv`, which only its unported benchmarks write,
    is cut; and so are the compile and runner-cache counts of obs's sweep
    line (the port compiles nothing and has no compiled-runner cache)."""
    lines = []
    for line in stdout.splitlines():
        if line.startswith(("[io] wrote ", "[obs] wrote ")):
            continue
        if out is not None:
            line = line.replace(str(Path(out)) + "/", "results/")
        line = re.sub(r"; see results/adaptive_gain\.csv$", "", line)
        line = re.sub(r"^(  sweep runs=\d+) compiles=.*$", r"\1", line)
        lines.append(line)
    return lines


def adaptive_table(frame) -> dict:
    """The reference entries of an adaptive_telemetry frame (either
    package's ResultFrame), in scenario order: see REFERENCE_ADAPTIVE."""
    import hashlib

    import numpy as np
    rows = []
    for i, (row, res) in enumerate(zip(frame.rows, frame.results)):
        k = int(np.argmax(res["throughput"]))
        links = frame.link_rows(i)
        ent = dict(label=f"{row['topology']}/{row['traffic']}/"
                         f"{row['routing']}")
        ent.update({key: res[key].tolist() for key in RAW})
        ent.update({key: row[key] for key in ADAPTIVE_ROW_KEYS})
        ent.update(
            lat_hist=res["lat_hist"][k].tolist(),
            per_phase=digest(*(res[key] for key in WL_RAW), dtype="int64"),
            link_counters=digest(res["link_busy"][k], res["link_stall"][k],
                                 res["link_occ_sum"][k]),
            link_occ_columns=digest([r["occ_escape"] for r in links],
                                    [r["occ_adaptive"] for r in links],
                                    dtype="float64"))
        rows.append(ent)
    win = frame.window_rows(len(frame.rows) - 1)
    return dict(table=rows, n_window_rows=len(win),
                window_rows=hashlib.sha256(json.dumps(
                    win, sort_keys=True).encode()).hexdigest())


def collective_scenarios(X, W, C) -> list:
    """The `collectives` phase's 20 scenarios at N = 64 (also built by
    tools/smoke_reference.py with the JAX package; C is the configs
    module): on each principled topology, organic, the training step of
    qwen3-1.7b (fsdp_gather, fwd_tp, bwd_tp, grad_reduce), that of
    qwen3-moe-235b-a22b (plus moe_a2a) and the MoE step beside a uniform
    serving tenant at 30% of the load; then folded_hexa_torus and mesh on
    glass under the qwen3-1.7b step."""
    grid = X.SaturationGrid(EXP_RATES)
    dense = C.get_config("qwen3-1.7b")
    moe = C.get_config("qwen3-moe-235b-a22b")
    workloads = [*W.collective_workloads([dense, moe]),
                 W.mixed_tenant(moe, "uniform", serve_frac=0.3)]
    out = [X.Scenario(name, COLL_N, "organic", wl, rates=grid)
           for name in PRINCIPLED for wl in workloads]
    out += [X.Scenario(name, COLL_N, "glass", workloads[0], rates=grid)
            for name in ICI_TOPOLOGIES]
    return out


def synth_scenarios(X, cands, config) -> list:
    """Stage 2's scenarios of a search, as `synth.evaluate.
    simulate_candidates` builds them (either package's classes)."""
    return [X.Scenario(topology=c.topo, n=c.topo.n, traffic=config.traffic,
                       rates=X.SaturationGrid(config.n_rates))
            for c in cands]


def synth_table(res, X, io, engine=None) -> dict:
    """The reference entries of a `SearchResult` (either package's; X and
    io its experiments package and writer): see REFERENCE_SYNTH."""
    import hashlib
    import os
    import tempfile
    st = res.state
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "synth.csv")
        io.write_csv(path, res.rows())
        csv = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    pool = sorted(c.topo.structural_hash() for c in st.pool)
    plan = X.plan(X.Experiment(synth_scenarios(X, res.simulated, st.config),
                               cfg=st.config.cfg, name="synth_sim"), engine)
    return dict(
        stats=dict(st.stats), n_pool=len(pool),
        pool=hashlib.sha256("\n".join(pool).encode()).hexdigest(),
        rejected=[[r["name"], r["origin"], r["reasons"], r["diag_codes"]]
                  for r in st.rejected],
        simulated=[dict(name=c.topo.name, origin=c.origin,
                        analytic=c.analytic, sim=c.sim)
                   for c in res.simulated],
        front=[c.topo.name for c in res.front()],
        front_eps=[c.topo.name for c in res.front(0.05)],
        fht_on_front=res.on_front("folded_hexa_torus", eps=0.05),
        prefilter_ratio=res.prefilter_ratio, rows_csv=csv,
        buckets=[[b.key.shape.n, b.key.shape.p, b.key.shape.c,
                  b.key.shape.d] for b in plan.buckets])


def analysis_table(cli_doc: dict, cli_rc: int, fht_report) -> dict:
    """The reference entries of the `analysis` phase: the CLI's exit code
    and its DP, RT and JX001-JX003 diagnostics (code, target, message)
    from its JSON artifact, with a digest of what it analyzed, and the
    diagnostics and analyzed targets of `analyze(names=["folded_hexa_
    torus"], n=36, fault_kmax=2)`: see REFERENCE_ANALYSIS."""
    import hashlib
    return dict(
        cli_rc=cli_rc,
        cli=[[r["code"], r["target"], r["message"]] for r in cli_doc["rows"]
             if r["code"] not in ANALYSIS_OWN_CODES],
        cli_analyzed=hashlib.sha256(json.dumps(
            cli_doc["analyzed"]).encode()).hexdigest(),
        fht=[[d.code, d.target, d.message] for d in fht_report],
        fht_analyzed=[list(a) for a in fht_report.analyzed])


def profile_cycles(torch, run, cycles: int, sessions: int = 3,
                   host_ops: bool = True) -> dict:
    """torch.profiler over `run()` (simulating `cycles` cycles): wall s,
    device busy s, device launches per cycle, idle share, and the eight
    costliest device ops' us per cycle.  The profiler on the card
    sometimes records no device event in a session, so a session that
    saw none is repeated, up to `sessions` times; None if none did.
    host_ops=False records device activity only, which parses several
    times faster (the device rows are the same)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    for _ in range(sessions):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = device_rows(prof)
        busy_s = sum(device_us(e) for e in events) / 1e6
        if busy_s > 0:
            break
    top = sorted(events, key=device_us, reverse=True)[:8]
    seen = busy_s > 0
    return dict(wall_s=wall_s, device_busy_s=busy_s if seen else None,
                device_launches_per_cycle=sum(e.count for e in events)
                / cycles if seen else None,
                device_idle_share=1 - busy_s / wall_s if seen else None,
                top_device_us={e.key[:60]: device_us(e) / cycles
                               for e in top})


def random_alloc_inputs(torch, gen, shape, device):
    pi = shape[-2]
    op_slot = torch.randint(-1, pi, shape, generator=gen,
                            dtype=torch.int32)
    eligible = (torch.rand(shape, generator=gen) < 0.5) & (op_slot >= 0)
    return op_slot.to(device), eligible.to(device)


def compare_kernel(torch, netstep, netstep_ref, op_slot, eligible, rr_vc,
                   rr_port) -> int:
    """Kernel vs plain version on the card; returns the max abs error
    (0 when bitwise equal) and raises on any difference."""
    got = netstep(op_slot, eligible, rr_vc, rr_port)
    want = netstep_ref(op_slot, eligible, rr_vc, rr_port)
    torch.cuda.synchronize()
    err = 0
    for g, w, name in zip(got, want, ("win_mask", "vc_choice", "out_req")):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} shape/dtype {tuple(g.shape)} {g.dtype}")
        e = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        err = max(err, e)
        check(torch.equal(g, w), f"{name} differs at shape "
              f"{tuple(op_slot.shape)}: max abs err {e}")
    win, vc, req = got
    # allocation invariants (tests/test_kernels.py): one winning VC per
    # input port, winners eligible, one winner per (router, out slot)
    check(bool((win.sum(dim=3) <= 1).all()), "two VCs won one port")
    check(bool((win <= eligible).all()), "an ineligible VC won")
    for o in range(op_slot.shape[2]):
        per_slot = ((op_slot == o) & win).sum(dim=(2, 3))
        check(bool((per_slot <= 1).all()), f"out slot {o} granted twice")
    return err


def ptxas_lines(lib_path) -> list:
    """The register and spill lines of a library's build log."""
    log = lib_path.with_suffix(".log")
    return [ln.strip() for ln in (log.read_text().splitlines()
                                  if log.exists() else [])
            if "registers" in ln or "spill" in ln]


def ptxas_functions(lib_path) -> dict:
    """Per kernel function of a library's build log (ptxas -v): its
    registers and spill store / load bytes."""
    log = lib_path.with_suffix(".log")
    out, name = {}, None
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def spill_bytes(ptxas) -> list:
    """The spill store and load byte counts of ptxas lines."""
    return [int(n) for ln in ptxas
            for n in re.findall(r"(\d+) bytes spill", ln)]


def sass_counts(lib_path, nvcc_path) -> dict:
    """Tensor-core and warp match / reduce instructions in a library's
    SASS (cuobjdump -sass)."""
    tool = Path(nvcc_path).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA", "MATCH", "REDUX")}


def netstep_bound(shape, n_bytes):
    """(bound ms, bound_by, ops): every input read once and every output
    written once, over the memory rate; per input port V compare-selects
    of phase a, one compare per out slot in phase b and V stores (a lower
    bound on the operations), over the float32 rate."""
    b, n, pi, v = shape
    n_ops = b * n * pi * (3 * v + 3 * pi)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_OPS_PER_S
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_ops)


def device_rows(prof) -> list:
    """Profiler rows that ran on the card (kernels, copies, fills)."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0]


def device_us(event) -> float:
    """Self device time (us) of a profiler row, across torch versions."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def time_ms(torch, fn, samples: int, reps: int) -> float:
    """Median over `samples` of the mean time of `reps` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# LM serving path: flash attention (qwen3-1.7b) and SSD scan (mamba2-1.3b)
# ---------------------------------------------------------------------------

def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_close(torch, got, want, tol, what) -> float:
    err = max_err(got, want)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{what}: max abs err {err} above tolerance {tol}")
    return err


def mean_err(got, want) -> float:
    return float((got.float() - want.float()).abs().mean())


def prefill_logits(model, tokens, kernels):
    """Last-position prefill logits (float32) with both kernels on or
    off; the model's config is left with them on."""
    model.cfg = dataclasses.replace(model.cfg, use_flash_kernel=bool(kernels),
                                    use_ssd_kernel=bool(kernels))
    logits, _ = model.prefill(tokens)
    model.cfg = dataclasses.replace(model.cfg, use_flash_kernel=True,
                                    use_ssd_kernel=True)
    return logits.float()


def randn(torch, gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dtype=dtype, device=dev)


def flash_inputs(torch, gen, b, tq, tk, h, kv, hd, dtype, dev):
    return (randn(torch, gen, (b, tq, h, hd), dtype, dev),
            randn(torch, gen, (b, tk, kv, hd), dtype, dev),
            randn(torch, gen, (b, tk, kv, hd), dtype, dev))


def ssd_inputs(torch, gen, b, t, h, p, n, dtype, dev):
    """x, B, C normal in `dtype`; dt in [0.05, 0.9) and a in (-2, -0.3]
    float32, as tests/test_kernels.py draws them."""
    dt = torch.rand((b, t, h), generator=gen) * 0.85 + 0.05
    a = -(torch.rand((h,), generator=gen) * 1.7 + 0.3)
    return (randn(torch, gen, (b, t, h, p), dtype, dev), dt.to(dev),
            a.to(dev), randn(torch, gen, (b, t, n), dtype, dev),
            randn(torch, gen, (b, t, n), dtype, dev))


def flash_bound(torch, q, k, v, causal=True, window=None):
    """(bound ms, bound_by, bytes, flops): q, k, v read once, o written
    once; 4 flops per (q, k) pair the causal (and window) mask keeps and
    head dim (causal: Tq = Tk)."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    if not causal:
        pairs = tq * tk
    elif window is None or window >= tq:
        pairs = tq * (tq + 1) // 2
    else:
        pairs = window * (window + 1) // 2 + (tq - window) * window
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    flops = 4 * b * h * hd * pairs
    return bound(n_bytes, flops, str(q.dtype).split(".")[-1])


def ssd_bound(x, dt, a, bm, cm, chunk):
    """(bound ms, bound_by, bytes, flops): every input read once, y and
    the f32 state written once; the multiply-adds of C Bᵀ on and below
    the diagonal (once per batch, not per head), of the masked scores
    times dt x, of C S and of the state update."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    tri = chunk * (chunk + 1) // 2 * (t // chunk)
    n_bytes = (sum(v.numel() * v.element_size() for v in (x, dt, a, bm, cm))
               + x.numel() * x.element_size() + 4 * b * h * n * p)
    macs = b * tri * n + b * h * tri * p + 2 * b * t * h * n * p
    return bound(n_bytes, 2 * macs, str(x.dtype).split(".")[-1])


def bound(n_bytes, flops, dtype_name):
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype_name]
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, flops)


def first(device_ms, events_ms):
    """A kernel's time: its device time from the profiler, or, where the
    profiler saw none, its CUDA-event time."""
    return device_ms if device_ms is not None else events_ms


def wrapper_device_ms(torch, fn, calls: int = 5, sessions: int = 3):
    """(device ms, {kernel: device ms}) of one call of `fn`: each CUDA
    kernel's mean device time per launch, summed over the kernels (every
    kernel of a wrapper launches once per call).  The profiler on the
    card sometimes records no device event in a session, so a session
    that saw none is repeated, up to `sessions` times; None if none did."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_kernel = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per_kernel = {e.key[:60]: device_us(e) / e.count / 1e3
                      for e in device_rows(prof)}
        if per_kernel:
            break
    total = sum(per_kernel.values())
    return (total if total > 0 else None), per_kernel


def cycle_bytes(a: dict) -> tuple:
    """(cycle_route bytes, cycle_move bytes): a lower bound on what each
    fused cycle kernel reads and writes in one launch at the shapes of
    the kernels' arguments `a`, whatever the traffic.  cycle_route reads
    every VC's head, count, head flit and route entry and writes its
    op_slot and eligible (19 B a VC); reads and writes every out-port
    VC's credit and reads its credit-pipe slot (12 B); reads each port's
    two channel ids (8 B), each channel's link slot (12 B), each node's
    injection bits (16 B) and weight a row (4 B), and rr (12 B a row).
    Adaptive runs (`prod` given) add each VC's productive-port word and
    its dvc store (8 B a VC); the recorder (its counters given) adds each
    channel's occupancy, read and written (8 B a channel VC).
    cycle_move reads the allocation (win 1 B a VC, vc and req 8 B a
    port) and rr (8 B a row); what the winners move (their dvc, the
    recorder's traversals and ejections among it) depends on the
    traffic and is left out."""
    B, N, PI, V, _ = a["buf_dst"].shape
    C = a["link_dst"].shape[1]
    P = PI - 1
    route = (19 * B * N * PI * V + 12 * B * N * P * V + 8 * B * N * P
             + 12 * B * C + 16 * N + 4 * B * N + 12 * B)
    if a.get("prod") is not None:
        route += 8 * B * N * PI * V
    if a.get("tel_busy") is not None:
        route += 8 * B * C * V
    move = B * N * PI * V + 8 * B * N * PI + 8 * B
    return route, move


#: cell 3's simulator settings (perfbench `fig4-n256-organic.hotspot-
#: adaptive`): Fig. 4's cycles, adaptive routing, the recorder in 6
#: windows, under a hotspot drifting over 6 phases of 200 cycles
CYCLE_ADAPTIVE = dict(routing="adaptive", telemetry=True,
                      telemetry_windows=6)
CYCLE_HOTSPOT = dict(n_phases=6, dwell=200)
# the cycles of the two runs whose difference times a body's cycle, and
# the pairs whose median it takes (the first pair also warms up)
LOOP_CYCLES = (300, 1300)
LOOP_ROUNDS = 3


def cycle_resources(lib_path, nvcc_path) -> dict:
    """{kernel: {registers, stack, local}} of every cycle_route /
    cycle_move instantiation in a library (cuobjdump
    --dump-resource-usage), named `cycle_route<4>` (<kV> before the
    adaptive and recorder template arguments) or `cycle_route<4, 0, 1>`
    (<kV, kAdaptive, kRecord>)."""
    tool = Path(nvcc_path).parent / "cuobjdump"
    text = subprocess.run([str(tool), "--dump-resource-usage",
                           str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function (\w+):", ln)
        if m:
            k = re.search(r"(cycle_route|cycle_move)ILi(\d+)E"
                          r"(?:Lb([01])ELb([01])E)?E", m.group(1))
            name = None
            if k:
                name = f"{k.group(1)}<{k.group(2)}" + (
                    f", {k.group(3)}, {k.group(4)}>" if k.group(3)
                    else ">")
            continue
        if name:
            regs = re.search(r"REG:(\d+)", ln)
            if regs:
                out[name] = dict(
                    registers=int(regs.group(1)),
                    stack=int(re.search(r"STACK:(\d+)", ln).group(1)),
                    local=int(re.search(r"LOCAL:(\d+)", ln).group(1)))
                name = None
    return out


def cycle_mode(torch, group, group_rates, cfg, schedules, label) -> dict:
    """One mode of `cycle_kernels` at a group: the fused run equals the
    PyTorch body on the card (alloc="torch") in every result key, bit
    for bit; from its last state cycle_route and cycle_move equal their
    plain versions cycle by cycle; then each kernel's device time a
    launch (profiler), a cycle's CUDA-event time, the byte bounds, the
    plain versions' times, and the graphed loop's µs a cycle on each
    body (the difference of a LOOP_CYCLES run pair)."""
    import numpy as np
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.cycle import ops as cops
    from repro_torch.kernels.cycle.ref import cycle_move_ref, cycle_route_ref
    from repro_torch.kernels.netstep.ops import netstep
    # the fused run, keeping its kernels' arguments: they end at cycle
    # cfg.cycles with the network loaded at each row's rate
    held, route = {}, sim.cycle_route

    def keep(a, measuring):
        held.setdefault("a", a)
        route(a, measuring)
    sim.cycle_route = keep
    try:
        fused = sim.run_batch(group, group_rates, cfg, schedules=schedules)
    finally:
        sim.cycle_route = route
    check("a" in held, f"{label}: the group missed the fused body")
    on_torch = sim.run_batch(group, group_rates, cfg._replace(alloc="torch"),
                             schedules=schedules)
    keys = 0
    for i, (f, b) in enumerate(zip(fused, on_torch)):
        check(f.keys() == b.keys(), f"{label} spec {i}: result keys differ")
        for key in f:
            if key == "pad_fill":
                continue
            x, y = np.asarray(f[key]), np.asarray(b[key])
            check(np.array_equal(x, y, equal_nan=x.dtype.kind == "f"),
                  f"{label} spec {i} {key}: fused {x.tolist()} torch body "
                  f"{y.tolist()}")
            keys += 1

    # each kernel against its plain version, cycle by cycle, from the
    # fused run's last state
    def clone(a):
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in a.items()}

    def same(x, y, what):
        for k in cops.ARGS:
            if k != "ticket" and isinstance(x.get(k), torch.Tensor):
                check(torch.equal(x[k], y[k]),
                      f"{label} {what} at cycle {int(y['t'][0])}: {k} "
                      f"differs")

    a = held["a"]
    hold = a["rate_t"] is not None
    if hold:
        # the phase tables end at cfg.cycles: go on from the first
        # measured cycle, and keep the timed cycles there
        a["t"].fill_(cfg.warmup)
    ka, ra = clone(a), clone(a)
    for _ in range(CYCLE_CHECKS):
        cops.cycle_route(ka, True)
        cycle_route_ref(ra, True)
        torch.cuda.synchronize()
        same(ka, ra, "cycle_route")
        win, vc, req = netstep(ka["op_slot"], ka["eligible"], ka["rr_vc"],
                               ka["rr_port"])
        cops.cycle_move(ka, win, vc, req, True)
        cycle_move_ref(ra, win, vc, req, True)
        torch.cuda.synchronize()
        same(ka, ra, "cycle_move")

    def one_cycle(x=ka):
        cops.cycle_route(x, True)
        cops.cycle_move(x, *netstep(x["op_slot"], x["eligible"],
                                    x["rr_vc"], x["rr_port"]), True)
        if hold:
            x["t"].fill_(cfg.warmup)

    cycle_ms = time_ms(torch, one_cycle, TIMING_SAMPLES, LAUNCHES_PER_SAMPLE)
    per_kernel = wrapper_device_ms(torch, one_cycle,
                                   calls=NETSTEP_PROFILED_CALLS)[1]
    pa = clone(a)
    route_plain_ms = time_ms(torch, lambda: cycle_route_ref(pa, True),
                             PLAIN_CYCLE_SAMPLES, PLAIN_CYCLE_REPS)
    win, vc, req = netstep(pa["op_slot"], pa["eligible"], pa["rr_vc"],
                           pa["rr_port"])

    # every call pops this allocation's winners again: the counts drift,
    # every index the plain version forms stays in range
    move_plain_ms = time_ms(torch, lambda: cycle_move_ref(
        pa, win, vc, req, True), PLAIN_CYCLE_SAMPLES, PLAIN_CYCLE_REPS)

    def loop_us(fused_body: bool) -> float:
        """µs a measured cycle of the graphed loop on one body: the
        difference of two runs of LOOP_CYCLES cycles (set-up and readback
        cancel), the median of LOOP_ROUNDS pairs."""
        real = sim._fused
        if not fused_body:
            sim._fused = lambda device, cfg, probe: False
        try:
            per_cycle = []
            for _ in range(LOOP_ROUNDS):
                walls = []
                for n in LOOP_CYCLES:
                    run_cfg = cfg._replace(cycles=n, warmup=0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.run_batch(group, group_rates, run_cfg,
                                  schedules=schedules)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                per_cycle.append(1e6 * (walls[1] - walls[0])
                                 / (LOOP_CYCLES[1] - LOOP_CYCLES[0]))
        finally:
            sim._fused = real
        return sorted(per_cycle)[len(per_cycle) // 2]

    n_bytes = dict(zip(("cycle_route", "cycle_move"), cycle_bytes(a)))
    return dict(
        label=label, shape=list(a["op_slot"].shape), cycles=cfg.cycles,
        config={k: v for k, v in cfg._asdict().items()
                if k in ("routing", "telemetry", "telemetry_windows")},
        fused_equals_torch_body=True, keys_compared=keys,
        kernel_equals_plain_cycles=CYCLE_CHECKS,
        cycle_events_ms=cycle_ms, device_ms=per_kernel,
        kernel_device_ms={name: sum(v for k, v in per_kernel.items()
                                    if name in k) or None
                          for name in n_bytes},
        bytes=n_bytes,
        bound_ms={k: 1e3 * v / PEAK_BYTES_PER_S for k, v in n_bytes.items()},
        plain_ms=dict(cycle_route=route_plain_ms, cycle_move=move_plain_ms),
        loop_us_per_cycle=dict(fused=loop_us(True), torch_body=loop_us(False)))


def cycle_kernels_phase(torch, group, group_rates, group_topos,
                        launches) -> list:
    """`cycle_kernels`; returns the `kernels` entries of cycle_route and
    cycle_move (`launches`: the main path's) from the static mode."""
    from repro_torch import workloads as W
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.build import nvcc
    from repro_torch.kernels.cycle import ops as cops
    t0 = time.perf_counter()
    static = cycle_mode(torch, group, group_rates, sim.SimConfig(), None,
                        "static")
    scheds = [W.hotspot_drift(topo, **CYCLE_HOTSPOT).compile()
              for topo in group_topos]
    adaptive = cycle_mode(
        torch, group, group_rates,
        sim.SimConfig(cycles=EXP_CYCLES, warmup=EXP_WARMUP,
                      **CYCLE_ADAPTIVE), scheds, "hotspot_adaptive_recorder")
    lib = cops.LIB.library_path()
    resources = cycle_resources(lib, nvcc())
    check(resources, f"cuobjdump found no cycle kernel in {lib}")
    rows = []
    for name in ("cycle_route", "cycle_move"):
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/cycle/csrc/cycle.cu",
            replaces="src/repro/core/simulator.py:585",
            launches=launches[name], max_abs_err=0,
            ms=static["kernel_device_ms"][name],
            plain_ms=static["plain_ms"][name],
            bound_ms=static["bound_ms"][name],
            bound_by="bytes", bytes=static["bytes"][name], library_ms=None))
    emit("cycle_kernels", shape=static["shape"], cycles=static["cycles"],
         fused_equals_torch_body=True, modes=[static, adaptive],
         resource_usage=resources,
         ptxas=ptxas_functions(lib),
         kernels=rows, seconds=round(time.perf_counter() - t0, 3))
    return rows


# ---------------------------------------------------------------------------
# the experiment path: phase-schedule workloads, faults, Scenario -> plan ->
# execute -> ResultFrame
# ---------------------------------------------------------------------------

def workload_phase(torch, dev, netstep) -> int:
    """`workload_kernel_vs_plain`; returns the kernel's launches."""
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as T
    from repro_torch.core import traffic as TR
    from repro_torch.core.routing import build_routing
    t0 = time.perf_counter()
    specs, scheds = [], []
    for i, (topo_name, n) in enumerate(WL_HETERO):
        r = build_routing(T.build(topo_name, n))
        u, t = TR.uniform(r.topo), TR.tornado(r.topo)
        specs.append(sim.make_spec(r, u))
        scheds.append(sim.make_sched_spec(wl_phases(i, u, t)))
    cfg = sim.SimConfig(cycles=300, warmup=100)
    wl_kw = dict(schedules=scheds, k_pad=WL_K_PAD)
    before = netstep.launches
    on_kernel = sim.run_batch(specs, WL_RATES, cfg, device=dev, **wl_kw)
    wl_launches = netstep.launches - before
    check(wl_launches == cfg.cycles,
          f"the workload batch launched {wl_launches} kernels for "
          f"{cfg.cycles} cycles")
    on_plain = sim.run_batch(specs, WL_RATES, cfg._replace(alloc="torch"),
                             device=dev, **wl_kw)
    on_cpu = sim.run_batch(specs, WL_RATES, cfg, device="cpu", **wl_kw)
    for (topo_name, n), k, p, c in zip(WL_HETERO, on_kernel, on_plain,
                                       on_cpu):
        for key in RAW + WL_RAW:
            check((k[key] == p[key]).all() and (k[key] == c[key]).all(),
                  f"workload {topo_name}{n} {key}: kernel "
                  f"{k[key].tolist()} plain {p[key].tolist()} cpu "
                  f"{c[key].tolist()}")
    emit("workload_kernel_vs_plain",
         specs=[f"{a}{b}" for a, b in WL_HETERO], rates=WL_RATES,
         k_pad=WL_K_PAD, phases=[s.k for s in scheds], cycles=cfg.cycles,
         bitwise_equal=True, kernel_launches=wl_launches,
         delivered_ph={f"{a}{b}": k["delivered_ph"].tolist()
                       for (a, b), k in zip(WL_HETERO, on_kernel)},
         seconds=round(time.perf_counter() - t0, 3))
    return wl_launches


def experiments_phase(torch, dev, smi, netstep, static_profile) -> int:
    """`experiments`; returns netstep's launches in the Experiment's run.
    `static_profile` is the `profile` phase's reading of a static group
    at the same shape, printed beside the workload group's."""
    from repro_torch import experiments as X
    from repro_torch import faults as F
    from repro_torch import workloads as W
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as T
    from repro_torch.sweep.engine import S_ROUND, SweepEngine
    t0 = time.perf_counter()
    exp_cfg = sim.SimConfig(cycles=EXP_CYCLES, warmup=EXP_WARMUP)
    exp = X.Experiment(experiment_scenarios(X, W, F, T), cfg=exp_cfg,
                       name="chip_smoke", backend="sim")
    engine = SweepEngine(cfg=exp_cfg, device=dev)
    plan = X.plan(exp, engine)
    kinds = [b.key.kind for b in plan.buckets]
    setup_s = time.perf_counter() - t0
    group_ms = {"static": [], "workload": []}

    def progress(done, total, key, info):
        group_ms[key.kind].append(1e3 * info["elapsed_s"] / exp_cfg.cycles)

    torch.cuda.synchronize()
    netstep.launches = 0
    t1 = time.perf_counter()
    frame = X.execute(plan, engine=engine, on_error="raise",
                      progress=progress)
    torch.cuda.synchronize()
    exp_wall_s = time.perf_counter() - t1
    exp_launches = netstep.launches
    exp_groups = engine.stats["groups"]
    check(exp_groups == len(plan.buckets),
          f"{exp_groups} engine groups for {len(plan.buckets)} buckets")
    check(exp_launches == exp_cfg.cycles * exp_groups,
          f"the experiment launched netstep {exp_launches} times for "
          f"{exp_cfg.cycles} cycles x {exp_groups} groups")
    check(len(frame.rows) == len(REFERENCE_EXPERIMENTS),
          f"{len(frame.rows)} rows for {len(REFERENCE_EXPERIMENTS)} "
          f"reference scenarios")
    for row, res, ref in zip(frame.rows, frame.results,
                             REFERENCE_EXPERIMENTS):
        label = f"{row['topology']}/{row['traffic']}/{row['faults']}"
        check(row["status"] == "ok" and label == ref["label"],
              f"row {label} status {row['status']} ({ref['label']})")
        for key in ("delivered", "lat_sum"):
            check(res[key].tolist() == ref[key],
                  f"{label} {key} {res[key].tolist()} != {ref[key]}")
        for key in ("sim_saturation", "abs_throughput_gbps", "latency_ns"):
            check(row[key] == ref[key],
                  f"{label} {key} {row[key]!r} != {ref[key]!r}")
        if "delivered_ph" in ref:
            got = res["delivered_ph"][int(res["throughput"].argmax())]
            check(got.tolist() == ref["delivered_ph"],
                  f"{label} delivered_ph {got.tolist()} != "
                  f"{ref['delivered_ph']}")
    check_s = time.perf_counter() - t1 - exp_wall_s
    # launches per cycle and idle share of the widest workload group (most
    # phases at the widest shape), one engine group as the engine pads it
    widest = max((b for b in plan.buckets if b.key.kind == "workload"),
                 key=lambda b: (b.key.shape, b.key.k_pad))
    items = list(widest.items)
    while len(items) % S_ROUND:
        items.append(items[-1])

    def group_run(cycles):
        return lambda: sim.run_batch(
            [ps.spec for ps in items], [ps.rates for ps in items],
            sim.SimConfig(cycles=cycles, warmup=0),
            pad_shape=widest.key.shape,
            schedules=[ps.sched_spec for ps in items],
            k_pad=widest.key.k_pad, device=dev)

    t2 = time.perf_counter()
    group_run(2)()
    torch.cuda.synchronize()
    workload_profile = dict(
        shape=str(widest.key.shape), k_pad=widest.key.k_pad,
        live_specs=len(widest.items),
        **profile_cycles(torch, group_run(PROFILE_CYCLES), PROFILE_CYCLES))
    workload_profile.pop("top_device_us")
    profile_s = time.perf_counter() - t2
    emit("experiments", scenarios=len(exp.scenarios),
         rate_rows=sum(len(ps.rates) for b in plan.buckets
                       for ps in b.items),
         all_ok=True, rows_equal_reference=True, cycles=exp_cfg.cycles,
         groups=exp_groups, static_groups=kinds.count("static"),
         workload_groups=kinds.count("workload"),
         netstep_launches=exp_launches, setup_seconds=round(setup_s, 3),
         wall_seconds=exp_wall_s, check_seconds=check_s,
         ms_per_simulated_cycle=1e3 * exp_wall_s
         / (exp_cfg.cycles * exp_groups),
         ms_per_cycle_by_group=group_ms,
         profile_cycles=PROFILE_CYCLES, profile_seconds=profile_s,
         workload_group_profile=workload_profile,
         static_group_profile=static_profile,
         sim_saturation=[[f"{r['topology']}/{r['traffic']}/{r['faults']}",
                          r["sim_saturation"]] for r in frame.rows],
         seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    return exp_launches


def results_equal(got, want) -> list:
    """The keys of two run_batch result dicts that differ (values,
    shapes or dtypes; `pad_fill` by value)."""
    import numpy as np
    bad = sorted(set(got) ^ set(want))
    for key in set(got) & set(want):
        g, w = got[key], want[key]
        if isinstance(w, dict):
            ok = g == w
        else:
            g, w = np.asarray(g), np.asarray(w)
            ok = g.shape == w.shape and g.dtype == w.dtype and \
                np.array_equal(g, w)
        if not ok:
            bad.append(key)
    return bad


def adaptive_kernel_phase(torch, dev, netstep) -> int:
    """`adaptive_kernel_vs_plain`; returns the kernel's launches."""
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as T
    from repro_torch.core import traffic as TR
    from repro_torch.core.routing import build_routing
    t0 = time.perf_counter()
    cfg = sim.SimConfig(cycles=300, warmup=100, routing="adaptive",
                        telemetry=True, telemetry_windows=4)
    specs = []
    for topo_name, n in HETERO:
        r = build_routing(T.build(topo_name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    wl_specs, scheds = [], []
    for i, (topo_name, n) in enumerate(WL_HETERO):
        r = build_routing(T.build(topo_name, n))
        u, t = TR.uniform(r.topo), TR.tornado(r.topo)
        wl_specs.append(sim.make_spec(r, u))
        scheds.append(sim.make_sched_spec(wl_phases(i, u, t)))
    batches = {
        "hetero": (specs, HETERO, HETERO_RATES, {}),
        "workload": (wl_specs, WL_HETERO, WL_RATES,
                     dict(schedules=scheds, k_pad=WL_K_PAD))}
    launches, compared = 0, {}
    for what, (b_specs, names, rates, kw) in batches.items():
        before = netstep.launches
        on_kernel = sim.run_batch(b_specs, rates, cfg, device=dev, **kw)
        n_launch = netstep.launches - before
        check(n_launch == cfg.cycles,
              f"the adaptive {what} batch launched {n_launch} kernels for "
              f"{cfg.cycles} cycles")
        launches += n_launch
        on_plain = sim.run_batch(b_specs, rates, cfg._replace(alloc="torch"),
                                 device=dev, **kw)
        on_cpu = sim.run_batch(b_specs, rates, cfg, device="cpu", **kw)
        for (topo_name, n), k, p, c in zip(names, on_kernel, on_plain,
                                           on_cpu):
            bad = results_equal(k, p) + results_equal(k, c)
            check(not bad, f"adaptive {what} {topo_name}{n}: kernel, plain "
                  f"and CPU differ in {sorted(set(bad))}")
        compared[what] = sorted(on_kernel[0])
    emit("adaptive_kernel_vs_plain", cycles=cfg.cycles, routing=cfg.routing,
         telemetry_windows=cfg.telemetry_windows,
         specs={what: [f"{a}{b}" for a, b in names]
                for what, (_, names, _, _) in batches.items()},
         k_pad=WL_K_PAD, keys_compared=compared, bitwise_equal=True,
         kernel_launches=launches,
         seconds=round(time.perf_counter() - t0, 3))
    return launches


def adaptive_phase(torch, dev, smi, netstep, static_profile) -> int:
    """`adaptive_telemetry`; returns netstep's launches in the
    Experiment's run.  `static_profile` is the `profile` phase's reading
    of a static group at the main path's shape."""
    import numpy as np
    from repro_torch import experiments as X
    from repro_torch import workloads as W
    from repro_torch.core import simulator as sim
    from repro_torch.obs import profile as P
    from repro_torch.sweep.engine import S_ROUND, SweepEngine
    check(REFERENCE_ADAPTIVE is not None, "REFERENCE_ADAPTIVE is missing")
    t0 = time.perf_counter()
    cfg = adaptive_cfg(sim.SimConfig)
    exp = X.Experiment(adaptive_scenarios(X, W), cfg=cfg,
                       name="chip_smoke_adaptive", backend="sim")
    engine = SweepEngine(cfg=cfg, device=dev)
    plan = X.plan(exp, engine)
    setup_s = time.perf_counter() - t0
    group_ms = {"static": [], "adaptive": []}

    def progress(done, total, key, info):
        group_ms[key.routing].append(1e3 * info["elapsed_s"] / cfg.cycles)

    torch.cuda.synchronize()
    netstep.launches = 0
    t1 = time.perf_counter()
    frame = X.execute(plan, engine=engine, on_error="raise",
                      progress=progress)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    launches = netstep.launches
    groups = engine.stats["groups"]
    check(groups == len(plan.buckets),
          f"{groups} engine groups for {len(plan.buckets)} buckets")
    check(launches == cfg.cycles * groups,
          f"the adaptive Experiment launched netstep {launches} times for "
          f"{cfg.cycles} cycles x {groups} groups")
    # the recorder's exact invariants: conservation, and windows that sum
    # to the aggregates over a partition of the measured cycles
    windowed = (("link_busy", "link_busy_w"), ("link_stall", "link_stall_w"),
                ("link_occ_sum", "link_occ_w"), ("inj_node", "inj_node_w"),
                ("eject_node", "eject_node_w"))
    for row, res in zip(frame.rows, frame.results):
        label = f"{row['topology']}/{row['routing']}"
        check(row["status"] == "ok", f"{label} status {row['status']}")
        for got, want in ((res["eject_node"].sum(1), "delivered"),
                          (res["inj_node"].sum(1), "accepted_n"),
                          (res["lat_hist"].sum(1), "delivered")):
            check(np.array_equal(got, res[want]),
                  f"{label}: recorder sum {got.tolist()} != {want} "
                  f"{res[want].tolist()}")
        for agg, win in windowed:
            check(np.array_equal(res[win].sum(axis=1), res[agg]),
                  f"{label}: {win} does not sum to {agg}")
        check(int(res["window_cycles"].sum()) == cfg.cycles - cfg.warmup,
              f"{label}: windows cover {res['window_cycles'].tolist()}")
    got = adaptive_table(frame)
    want = REFERENCE_ADAPTIVE
    check(len(got["table"]) == len(want["table"]),
          f"{len(got['table'])} rows for {len(want['table'])} reference rows")
    for g, w in zip(got["table"], want["table"]):
        bad = [k for k in w if g.get(k) != w[k]]
        check(not bad, f"{w['label']}: {bad} differ from the JAX table: "
              f"{ {k: (g.get(k), w[k]) for k in bad} }")
    for k in ("n_window_rows", "window_rows"):
        check(got[k] == want[k], f"window_rows {k} {got[k]} != {want[k]}")
    sat = {e["label"]: e["sim_saturation"] for e in got["table"]}
    gains = {name: sat[f"{name}/hotspot_drift/adaptive"]
             / sat[f"{name}/hotspot_drift/static"] - 1
             for name in ADAPTIVE_TOPOLOGIES}
    check_s = time.perf_counter() - t1 - wall_s
    # one obs.profile record per runner key, in an untimed pass of its own
    t2 = time.perf_counter()
    P.clear_profiles()
    for b in plan.buckets:
        items = list(b.items)
        while len(items) % S_ROUND:
            items.append(items[-1])
        sim.profile_batch([ps.spec for ps in items],
                          [ps.rates for ps in items],
                          cfg._replace(routing=b.key.routing),
                          pad_shape=b.key.shape,
                          schedules=[ps.sched_spec for ps in items],
                          k_pad=b.key.k_pad, device=dev)
    profiles = P.get_profiles()
    profile_s = time.perf_counter() - t2
    # device launches per cycle and idle share (profiled, device rows
    # only) and ms per cycle (a timed run without the profiler) of the
    # widest adaptive group in each mode: routing x recorder
    widest = max((b for b in plan.buckets if b.key.routing == "adaptive"),
                 key=lambda b: (b.key.shape, b.key.k_pad))
    items = list(widest.items)
    while len(items) % S_ROUND:
        items.append(items[-1])
    modes = {}
    for routing in ("static", "adaptive"):
        for recorder in (False, True):
            mcfg = sim.SimConfig(
                cycles=PROFILE_CYCLES, warmup=0, routing=routing,
                telemetry=recorder,
                telemetry_windows=ADAPTIVE_WINDOWS if recorder else 0)

            def group_run(c, mcfg=mcfg):
                return lambda: sim.run_batch(
                    [ps.spec for ps in items], [ps.rates for ps in items],
                    mcfg._replace(cycles=c,
                                  telemetry_windows=min(c, mcfg.
                                                        telemetry_windows)),
                    pad_shape=widest.key.shape,
                    schedules=[ps.sched_spec for ps in items],
                    k_pad=widest.key.k_pad, device=dev)
            group_run(2)()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            group_run(MODE_TIMED_CYCLES)()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t3) / MODE_TIMED_CYCLES
            m = profile_cycles(torch, group_run(PROFILE_CYCLES),
                               PROFILE_CYCLES, host_ops=False)
            m.pop("top_device_us")
            modes[f"{routing}/recorder_{'on' if recorder else 'off'}"] = \
                dict(m, ms_per_cycle=ms)
    emit("adaptive_telemetry", n=MAIN_N, scenarios=len(exp.scenarios),
         rate_rows=sum(len(ps.rates) for b in plan.buckets
                       for ps in b.items),
         all_ok=True, rows_equal_reference=True, conservation=True,
         windows_sum_to_aggregates=True, cycles=cfg.cycles,
         telemetry_windows=cfg.telemetry_windows, groups=groups,
         groups_by_routing={r: [b.key.routing for b in plan.buckets].count(r)
                            for r in ("static", "adaptive")},
         netstep_launches=launches, setup_seconds=round(setup_s, 3),
         wall_seconds=wall_s, check_seconds=check_s,
         ms_per_simulated_cycle=1e3 * wall_s / (cfg.cycles * groups),
         ms_per_cycle_by_routing_recorder_on=group_ms,
         sim_saturation=sat, static_to_adaptive_gain=gains,
         widest_adaptive_group=dict(shape=str(widest.key.shape),
                                    k_pad=widest.key.k_pad,
                                    live_specs=len(widest.items)),
         profile_cycles=PROFILE_CYCLES, group_profile_by_mode=modes,
         static_group_profile=static_profile,
         obs_profile=profiles, profile_seconds=round(profile_s, 3),
         seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    return launches


def groups_kernel_vs_plain(dev, netstep, groups, what: str) -> int:
    """Each padded group `(shape, specs, rates)` for 300 cycles with the
    kernel and with the plain allocator, both on the card: every result
    key equal.  Returns the kernel's launches."""
    from repro_torch.core import simulator as sim
    cfg = sim.SimConfig(cycles=300, warmup=100)
    launches = 0
    for shape, specs, rates in groups:
        before = netstep.launches
        on_kernel = sim.run_batch(specs, rates, cfg, pad_shape=shape,
                                  device=dev)
        n_launch = netstep.launches - before
        check(n_launch == cfg.cycles,
              f"the {what} group {shape} launched {n_launch} kernels for "
              f"{cfg.cycles} cycles")
        launches += n_launch
        on_plain = sim.run_batch(specs, rates, cfg._replace(alloc="torch"),
                                 pad_shape=shape, device=dev)
        for i, (k, p) in enumerate(zip(on_kernel, on_plain)):
            bad = results_equal(k, p)
            check(not bad, f"{what} group {shape} spec {i}: kernel and "
                  f"plain differ in {bad}")
    return launches


def synth_phase(torch, dev, smi, netstep, static_profile) -> int:
    """`synth` and `synth_kernel_vs_plain`; returns netstep's launches in
    the search's stage 2.  `static_profile` is the `profile` phase's
    reading of a static group at the main path's shape."""
    from repro_torch import experiments as X
    from repro_torch import synth as S
    from repro_torch.core import simulator as sim
    from repro_torch.experiments import io as xio
    from repro_torch.obs.trace import (clear_trace, disable_tracing,
                                       enable_tracing, get_spans)
    from repro_torch.sweep.engine import S_ROUND, SweepEngine
    config = S.SearchConfig(n=SYNTH_N, substrate="organic", seed=0)
    cfg = config.cfg
    clear_trace()
    enable_tracing()
    torch.cuda.synchronize()
    netstep.launches = 0
    t0 = time.perf_counter()
    try:
        res = S.run_search(config, device=dev)
        torch.cuda.synchronize()
    finally:
        disable_tracing()
    wall_s = time.perf_counter() - t0
    launches = netstep.launches
    span_s = {}
    for sp in get_spans():
        if sp.name.startswith(("synth.", "sim.")):
            span_s[sp.name] = span_s.get(sp.name, 0.0) + sp.dur / 1e9
    analytic_s = sum(v for k, v in span_s.items()
                     if k.startswith("synth.") and k != "synth.simulate")
    # stage 2 with its set-up (scenarios, plan, specs, stacking), and the
    # groups' cycle loops alone (upload, issue and drain)
    simulate_s = span_s.get("synth.simulate", 0.0)
    loop_s = span_s.get("sim.dispatch", 0.0) + span_s.get("sim.wait", 0.0)
    engine = SweepEngine(cfg=cfg, device=dev)
    got = synth_table(res, X, xio, engine)
    groups = len(got["buckets"])
    check(launches == cfg.cycles * groups,
          f"the search launched netstep {launches} times for {cfg.cycles} "
          f"cycles x {groups} groups")
    for key, want in REFERENCE_SYNTH.items():
        if key == "simulated":
            check(len(got[key]) == len(want),
                  f"{len(got[key])} simulated for {len(want)}")
            for g, w in zip(got[key], want):
                check(g == w, f"simulated {w['name']}: {g} != {w}")
        elif key != "seconds":
            check(got[key] == want, f"synth {key} {got[key]!r} != {want!r}")
    check(res.on_front("folded_hexa_torus", eps=0.05),
          "folded_hexa_torus is not within 5% of the front")
    check(res.prefilter_ratio >= 5, f"prefilter {res.prefilter_ratio} < 5")
    # launches per cycle and idle share of the widest group, as the engine
    # pads it
    plan = X.plan(X.Experiment(synth_scenarios(X, res.simulated, config),
                               cfg=cfg, name="synth_sim"), engine)
    padded = {}
    for b in plan.buckets:
        items = list(b.items)
        while len(items) % S_ROUND:
            items.append(items[-1])
        padded[b.key.shape] = items
    widest = max(plan.buckets, key=lambda b: b.key.shape)
    items = padded[widest.key.shape]

    def group_run(cycles):
        return lambda: sim.run_batch(
            [ps.spec for ps in items], [ps.rates for ps in items],
            sim.SimConfig(cycles=cycles, warmup=0),
            pad_shape=widest.key.shape, device=dev)

    group_run(2)()
    torch.cuda.synchronize()
    widest_profile = dict(
        shape=str(widest.key.shape), live_specs=len(widest.items),
        **profile_cycles(torch, group_run(PROFILE_CYCLES), PROFILE_CYCLES,
                         host_ops=False))
    widest_profile.pop("top_device_us")
    emit("synth", n=SYNTH_N, stats=got["stats"], equal_reference=True,
         fht_on_front_eps_0_05=True, prefilter_ratio=res.prefilter_ratio,
         front=got["front"], front_eps=got["front_eps"],
         simulated=[c["name"] for c in got["simulated"]],
         sim_saturation={c["name"]: c["sim"]["sim_saturation"]
                         for c in got["simulated"]},
         cycles=cfg.cycles, groups=groups, padded_groups=got["buckets"],
         netstep_launches=launches, wall_seconds=wall_s,
         analytic_seconds=analytic_s, simulate_seconds=simulate_s,
         loop_seconds=loop_s, span_seconds=span_s,
         ms_per_simulated_cycle=1e3 * loop_s / (cfg.cycles * groups),
         stage2_ms_per_cycle_group_setup_included=1e3 * simulate_s / (
             cfg.cycles * groups),
         profile_cycles=PROFILE_CYCLES, widest_group_profile=widest_profile,
         static_group_profile=static_profile, nvidia_smi=smi)
    # the kernel on the inputs of every padded group of stage 2
    t1 = time.perf_counter()
    kvp_launches = groups_kernel_vs_plain(
        dev, netstep, [(shape, [ps.spec for ps in its],
                        [ps.rates for ps in its])
                       for shape, its in padded.items()], "synth")
    emit("synth_kernel_vs_plain", cycles=300,
         groups=[[s.n, s.p, s.c, s.d] for s in padded],
         pis=[s.p + 1 for s in padded], bitwise_equal=True,
         kernel_launches=kvp_launches,
         seconds=round(time.perf_counter() - t1, 3))
    return launches


def analysis_phase(torch, dev, smi, netstep) -> int:
    """`analysis`; returns netstep's launches in the in-process hazard
    pass (the CLI's run in its own process is not counted here)."""
    import os
    import tempfile
    from repro_torch import analysis as A
    from repro_torch.analysis import runner_hazards as H
    from repro_torch.core import simulator as sim
    from repro_torch.core import topology as T
    from repro_torch.core import traffic as TR
    from repro_torch.core.routing import routing_for
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "diagnostics.json")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--all-builtin",
             "--hazards", "-q", "-o", path], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=900)
        check(os.path.exists(path), f"the analysis CLI wrote nothing: "
              f"rc {proc.returncode}, {proc.stderr[-2000:]}")
        with open(path) as f:
            cli_doc = json.load(f)
    cli_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    fht = A.analyze(names=["folded_hexa_torus"], n=36, fault_kmax=2)
    fht_s = time.perf_counter() - t1
    got = analysis_table(cli_doc, proc.returncode, fht)
    for key, want in REFERENCE_ANALYSIS.items():
        if key != "seconds":
            check(got[key] == want,
                  f"analysis {key} {got[key]!r} != {want!r}")
    own = {(r["code"], r["witness"].get("op"), r["witness"].get("src"),
            r["witness"].get("dst", r["witness"].get("dtype")))
           for r in cli_doc["rows"] if r["code"] in ANALYSIS_OWN_CODES}
    check(own == set(H.INTENDED), f"the CLI's JX004 / JX005 findings "
          f"{sorted(own)} are not the intended {sorted(H.INTENDED)}")
    # the hazard pass's cycles on the card: the organic batch the CLI
    # traces, its op log on cuda but for the stated host-side ops
    topos = [T.build(name, T.nearest_valid_n(name, A.DEFAULT_N))
             for name in A.builtin_names()]
    specs = [sim.make_spec(routing_for(t), TR.uniform(t)) for t in topos]
    netstep.launches = 0
    t2 = time.perf_counter()
    log, shape, _ = sim.trace_batch(specs, [0.1], sim.SimConfig(),
                                    device=dev)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t2
    launches = netstep.launches
    check(launches == sim.TRACE_CYCLES,
          f"the traced cycles launched netstep {launches} times for "
          f"{sim.TRACE_CYCLES} cycles")
    host_ops = H.host_side_ops(log, torch.device(dev).type)
    check(set(host_ops) <= set(H.HOST_SIDE_OPS),
          f"loop ops off the card: {host_ops}")
    found = H.findings(H.check_host_sync(log)
                       + H.check_dtype_promotions(log))
    check(set(found) == set(H.INTENDED),
          f"the loop's JX004 / JX005 findings {found} are not the intended "
          f"{sorted(H.INTENDED)}")
    loop = H.loop_ops(log)
    # the kernel on the hazard pass's inputs
    t3 = time.perf_counter()
    kvp_launches = groups_kernel_vs_plain(dev, netstep,
                                          [(shape, specs, [0.1])], "hazard")
    kvp_s = time.perf_counter() - t3
    emit("analysis", cli_rc=proc.returncode,
         cli_summary=[line for line in proc.stdout.splitlines()
                      if "analyzed:" in line],
         cli_counts={c: sum(r["code"] == c for r in cli_doc["rows"])
                     for c in sorted({r["code"] for r in cli_doc["rows"]})},
         equal_reference=True, own_findings=sorted(own),
         intended=[dict(finding=list(k), reason=v)
                   for k, v in H.INTENDED.items()],
         fht_diagnostics=len(got["fht"]),
         fht_analyzed=len(got["fht_analyzed"]),
         trace_shape=str(shape), trace_specs=len(specs),
         trace_cycles=sim.TRACE_CYCLES, traced_ops=len(log),
         aten_ops_per_cycle=len(loop) / sim.TRACE_CYCLES,
         loop_host_side_ops=host_ops, netstep_launches=launches,
         sync_debug_mode="warn", loop_ops_waiting=sum(
             bool(r.synced) for r in loop),
         ops_waiting_outside_loop=sum(bool(r.synced) for r in log) - sum(
             bool(r.synced) for r in loop),
         kernel_vs_plain=dict(shape=str(shape), pi=shape.p + 1, cycles=300,
                              bitwise_equal=True,
                              kernel_launches=kvp_launches,
                              seconds=kvp_s),
         cli_seconds=cli_s, fht_seconds=fht_s, trace_seconds=trace_s,
         seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    return launches


def collectives_phase(torch, dev, smi, netstep) -> int:
    """`collectives`; returns netstep's launches in the Experiment's run."""
    from repro_torch import configs as C
    from repro_torch import experiments as X
    from repro_torch import workloads as W
    from repro_torch.core import simulator as sim
    from repro_torch.core.collectives import build_ici_model
    from repro_torch.sweep.engine import SweepEngine
    t0 = time.perf_counter()
    cfg = sim.SimConfig(cycles=EXP_CYCLES, warmup=EXP_WARMUP)
    exp = X.Experiment(collective_scenarios(X, W, C), cfg=cfg,
                       name="chip_smoke_collectives", backend="sim")
    engine = SweepEngine(cfg=cfg, device=dev)
    plan = X.plan(exp, engine)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    netstep.launches = 0
    t1 = time.perf_counter()
    frame = X.execute(plan, engine=engine, on_error="raise")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    launches = netstep.launches
    groups = engine.stats["groups"]
    check(groups == len(plan.buckets),
          f"{groups} engine groups for {len(plan.buckets)} buckets")
    check(launches == cfg.cycles * groups,
          f"the collectives Experiment launched netstep {launches} times "
          f"for {cfg.cycles} cycles x {groups} groups")
    ref_rows = REFERENCE_COLLECTIVES["table"]
    check(len(frame.rows) == len(ref_rows),
          f"{len(frame.rows)} rows for {len(ref_rows)} reference scenarios")
    phases = {}
    for row, res, ref in zip(frame.rows, frame.results, ref_rows):
        label = (f"{row['topology']}/{row['substrate']}/{row['traffic']}/"
                 f"{row['faults']}")
        check(row["status"] == "ok" and label == ref["label"],
              f"row {label} status {row['status']} ({ref['label']})")
        for key in RAW:
            check(res[key].tolist() == ref[key],
                  f"{label} {key} {res[key].tolist()} != {ref[key]}")
        for key in ("sim_saturation", "abs_throughput_gbps", "latency_ns"):
            check(row[key] == ref[key],
                  f"{label} {key} {row[key]!r} != {ref[key]!r}")
        got = res["delivered_ph"][int(res["throughput"].argmax())]
        check(got.tolist() == ref["delivered_ph"],
              f"{label} delivered_ph {got.tolist()} != "
              f"{ref['delivered_ph']}")
        phases[label] = got.tolist()
    # the ICI model through the simulator (default SimConfig, one group
    # each), against the JAX package's values
    t2 = time.perf_counter()
    netstep.launches = 0
    ici = {}
    for name in ICI_TOPOLOGIES:
        m = build_ici_model(name, COLL_N, "organic", use_sim=True,
                            device=dev)
        got = dict(b_eff_gbps=m.b_eff_gbps,
                   all_reduce_s=m.collective_time_s("all_reduce", ICI_BYTES))
        check(got == REFERENCE_COLLECTIVES["ici"][name],
              f"build_ici_model({name}) {got} != "
              f"{REFERENCE_COLLECTIVES['ici'][name]}")
        ici[name] = got
    ici_launches = netstep.launches
    check(ici_launches == sim.SimConfig().cycles * len(ICI_TOPOLOGIES),
          f"build_ici_model launched netstep {ici_launches} times")
    emit("collectives", n=COLL_N, scenarios=len(exp.scenarios),
         rate_rows=sum(len(ps.rates) for b in plan.buckets
                       for ps in b.items),
         all_ok=True, rows_equal_reference=True, cycles=cfg.cycles,
         groups=groups, netstep_launches=launches,
         setup_seconds=round(setup_s, 3), wall_seconds=wall_s,
         ms_per_simulated_cycle=1e3 * wall_s / (cfg.cycles * groups),
         sim_saturation=[[f"{r['topology']}/{r['substrate']}/"
                          f"{r['traffic']}", r["sim_saturation"]]
                         for r in frame.rows],
         delivered_ph_at_saturation=phases,
         ici_model=ici, ici_equal_reference=True,
         ici_netstep_launches=ici_launches,
         ici_seconds=round(time.perf_counter() - t2, 3),
         seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    return launches


def lm_phases(torch, dev, smi, fops, sops, serve):
    """The LM phases; returns the kernel summary rows of flash_attention
    and ssd_scan."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ablate
    from repro_torch.models import Model

    gen = torch.Generator().manual_seed(12)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # ---- flash attention vs plain, both routes -----------------------------
    t0 = time.perf_counter()
    errs = {}
    for dname, dtype in dtypes.items():
        for hd in FLASH_HEAD_DIMS:
            for tq, tk, causal, window in FLASH_CASES:
                q, k, v = flash_inputs(torch, gen, 2, tq, tk, 4, 2, hd, dtype,
                                       dev)
                got = fops.flash_attention(q, k, v, causal=causal,
                                           window=window)
                want = fops.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window)
                what = f"{dname} hd {hd} {tq}x{tk} causal={causal} " \
                       f"window={window}"
                errs[what] = check_close(torch, got, want, FLASH_TOL[dname],
                                         "flash " + what)
    fp = FLASH_PATH
    path_errs = {}
    for dname, dtype in dtypes.items():
        q, k, v = flash_inputs(torch, gen, fp["b"], fp["t"], fp["t"], fp["h"],
                               fp["kv"], fp["hd"], dtype, dev)
        path_errs[dname] = check_close(
            torch, fops.flash_attention(q, k, v, causal=True),
            fops.flash_attention_plain(q, k, v, causal=True),
            FLASH_TOL[dname], f"flash {dname} at the path shape")
        if dname == "float32":
            f32_flash = (q, k, v)
        else:
            fq, fk, fv = q, k, v
    # hd 256: GQA 4:1, causal, windows None / 1024 / 96, long and ragged
    for dname, dtype in dtypes.items():
        for tq, tk, window in HD256_CASES:
            q, k, v = flash_inputs(torch, gen, 2, tq, tk, 4, 1, 256, dtype,
                                   dev)
            what = f"{dname} hd 256 {tq}x{tk} causal=True window={window}"
            errs[what] = check_close(
                torch, fops.flash_attention(q, k, v, causal=True,
                                            window=window),
                fops.flash_attention_plain(q, k, v, causal=True,
                                           window=window),
                FLASH_TOL[dname], "flash " + what)
    # gemma3-1b's prefill shape, global and local layers
    gp = GEMMA_PATH
    gemma_errs, gemma_flash = {}, {}
    for dname, dtype in dtypes.items():
        gemma_flash[dname] = flash_inputs(torch, gen, gp["b"], gp["t"],
                                          gp["t"], gp["h"], gp["kv"],
                                          gp["hd"], dtype, dev)
        for window in (None, gp["window"]):
            gemma_errs[f"{dname} window={window}"] = check_close(
                torch, fops.flash_attention(*gemma_flash[dname], causal=True,
                                            window=window),
                fops.flash_attention_plain(*gemma_flash[dname], causal=True,
                                           window=window),
                FLASH_TOL[dname], f"flash {dname} at gemma3-1b's shape, "
                f"window {window}")
    # the families' prefill shapes: seamless hd 64 with 16 q over 16 kv
    # heads, jamba GQA 32:8, qwen3-moe a GQA group of 16
    fam_errs, fam_flash = {}, {}
    for arch, sh in FAMILY_FLASH.items():
        for dname, dtype in dtypes.items():
            qkv = flash_inputs(torch, gen, sh["b"], sh["t"], sh["t"], sh["h"],
                               sh["kv"], sh["hd"], dtype, dev)
            fam_errs[f"{arch} {dname}"] = check_close(
                torch, fops.flash_attention(*qkv, causal=True),
                fops.flash_attention_plain(*qkv, causal=True),
                FLASH_TOL[dname], f"flash {dname} at {arch}'s shape")
            if dname == "bfloat16":
                fam_flash[arch] = qkv
    flash_err = max(path_errs["bfloat16"],
                    *(e for w, e in gemma_errs.items()
                      if w.startswith("bfloat16")),
                    *(e for w, e in fam_errs.items()
                      if w.endswith("bfloat16")))
    emit("flash_vs_plain", cases=errs, path_shape=list(fq.shape),
         path_kv_heads=fp["kv"], path_max_abs_err=path_errs,
         gemma3_shape=list(gemma_flash["bfloat16"][0].shape),
         gemma3_kv_heads=gp["kv"], gemma3_max_abs_err=gemma_errs,
         families_shapes=FAMILY_FLASH, families_max_abs_err=fam_errs,
         tol=FLASH_TOL, seconds=round(time.perf_counter() - t0, 3))

    # ---- SSD scan vs plain, both routes ------------------------------------
    t0 = time.perf_counter()
    errs = {}
    cases = [(d, c) for d in dtypes for c in SSD_CASES] + \
        [("bfloat16", c) for c in SSD_BF16_CASES]
    for dname, (b, t, h, p, n, chunk) in cases:
        args = ssd_inputs(torch, gen, b, t, h, p, n, dtypes[dname], dev)
        y, st = sops.ssd_scan(*args, chunk=chunk)
        yr, sr = sops.ssd_ref(*args, chunk)
        what = f"{dname} {(b, t, h, p, n, chunk)}"
        errs[what] = dict(
            y=check_close(torch, y, yr, SSD_TOL[dname], f"ssd {what} y"),
            state=check_close(torch, st, sr, SSD_TOL[dname],
                              f"ssd {what} state"))
    def ssd_at(sp, what):
        """Both routes at a serving shape -> (errors, bf16 args, f32
        args).  bf16 at SSD_TOL (and, where |y| < 1, each route's
        distance from the f64 evaluation); f32: sums of 256 terms in two
        orders differ by more than 1e-4 here (the plain version is that
        far from its own f64 evaluation), so the kernel is held against
        the f64 evaluation: no further from it than the plain f32 version
        is, give or take F32_MARGIN."""
        out, kept = {}, {}
        for dname, dtype in dtypes.items():
            args = ssd_inputs(torch, gen, sp["b"], sp["t"], sp["h"], sp["p"],
                              sp["n"], dtype, dev)
            kept[dname] = args
            y, st = sops.ssd_scan(*args, chunk=sp["chunk"])
            yr, sr = sops.ssd_ref(*args, sp["chunk"])
            y64, s64 = sops.ssd_ref(*(v.double() for v in args), sp["chunk"])
            if dname == "bfloat16":
                # outputs near 0 sum terms that cancel: the kernel's and
                # the plain version's distance from f64 there
                small = y64.abs() < 1
                out[dname] = dict(
                    y=check_close(torch, y, yr, SSD_TOL[dname],
                                  f"ssd {dname} y at {what}"),
                    state=check_close(torch, st, sr, SSD_TOL[dname],
                                      f"ssd {dname} state at {what}"),
                    near_zero_vs_f64={
                        name: float((v.double() - y64).abs()[small].max())
                        for name, v in (("kernel", y), ("plain", yr))})
                continue
            errs64 = {}
            for part, got, plain, exact in (("y", y, yr, y64),
                                            ("state", st, sr, s64)):
                check(bool(torch.isfinite(got).all()),
                      f"ssd f32 {part} finite")
                k, pl = max_err(got, exact), max_err(plain, exact)
                check(k <= F32_MARGIN * pl, f"ssd f32 {part} at {what} is "
                      f"{k} from its f64 evaluation, the plain version {pl}")
                errs64[part] = dict(kernel_vs_plain=max_err(got, plain),
                                    kernel_vs_f64=k, plain_vs_f64=pl)
            out[dname] = errs64
        return out, kept["bfloat16"], kept["float32"]

    path_errs, ssd_args, f32_ssd = ssd_at(SSD_PATH, "the path shape")
    fam_ssd_errs, fam_ssd = {}, {}
    for arch, sh in FAMILY_SSD.items():
        fam_ssd_errs[arch], fam_ssd[arch], _ = ssd_at(sh, f"{arch}'s shape")
    ssd_err = max(path_errs["bfloat16"]["y"],
                  *(e["bfloat16"]["y"] for e in fam_ssd_errs.values()))
    emit("ssd_vs_plain", cases=errs, path_shape=dict(SSD_PATH),
         path_max_abs_err=path_errs, families_shapes=FAMILY_SSD,
         families_max_abs_err=fam_ssd_errs, tol=SSD_TOL,
         seconds=round(time.perf_counter() - t0, 3))

    # ---- the card against the CPU, full width, depth 2, f32 ----------------
    t0 = time.perf_counter()
    cvc = CARD_VS_CPU
    rows = {}
    for arch in SERVE_LAUNCHES:
        cfg = dataclasses.replace(
            get_config(arch), n_layers=cvc["depth"],
            compute_dtype=torch.float32, use_flash_kernel=True,
            use_ssd_kernel=True)
        cpu_model = Model(cfg).init(torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu_model).to(dev)
        rng = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (cvc["batch"], cvc["prompt"]),
                               generator=rng)
        steps = torch.randint(0, cfg.vocab, (cvc["decode"], cvc["batch"], 1),
                              generator=rng)

        def run(model, device, kernels):
            model.cfg = dataclasses.replace(model.cfg,
                                            use_flash_kernel=kernels,
                                            use_ssd_kernel=kernels)
            logits, caches = model.prefill(prompt.to(device))
            outs = [logits.cpu()]
            for i in range(cvc["decode"]):
                logits, caches = model.decode_step(
                    caches, steps[i].to(device), cvc["prompt"] + i)
                outs.append(logits[:, -1].cpu())
            return outs

        before = (fops.flash_attention.launches, sops.ssd_scan.launches)
        kern = run(card, dev, True)
        launched = (fops.flash_attention.launches - before[0],
                    sops.ssd_scan.launches - before[1])
        plain = run(card, dev, False)
        cpu = run(cpu_model, torch.device("cpu"), True)
        name = SERVE_LAUNCHES[arch][0]
        n_launched = launched[0] if name == "flash_attention" else launched[1]
        check(n_launched == cvc["depth"],
              f"{arch}: {n_launched} {name} launches for {cvc['depth']} "
              f"layers")
        errs = {}
        for label, other in (("kernel_vs_plain", plain),
                             ("kernel_vs_cpu", cpu), ("plain_vs_cpu", cpu)):
            mine = plain if label == "plain_vs_cpu" else kern
            errs[label] = [check_close(torch, a, b, cvc["tol"],
                                       f"{arch} {label} step {i}")
                           for i, (a, b) in enumerate(zip(mine, other))]
        # the same two layers in bf16 on the card: kernel path vs plain
        # path prefill at the tolerance tests/test_integration.py sets
        card.cfg = dataclasses.replace(card.cfg, compute_dtype=torch.bfloat16)
        bf16 = [prefill_logits(card, prompt.to(dev), on) for on in (1, 0)]
        errs["kernel_vs_plain_bf16_prefill"] = check_close(
            torch, bf16[0], bf16[1], SERVE_TOL, f"{arch} depth-2 bf16 prefill")
        rows[arch] = dict(launches={name: n_launched}, max_abs_err=errs,
                          logits_abs_max=float(kern[0].abs().max()))
        del cpu_model, card
        torch.cuda.empty_cache()
    emit("lm_card_vs_cpu", depth=cvc["depth"], batch=cvc["batch"],
         prompt=cvc["prompt"], decode_steps=cvc["decode"],
         compute_dtype="float32", tol=cvc["tol"], bf16_tol=SERVE_TOL,
         archs=rows,
         seconds=round(time.perf_counter() - t0, 3))

    # ---- the serving path, full depth and width ----------------------------
    launches, serve_launches = {}, {}
    serve_rows = {}
    for arch, (name, per_prefill) in SERVE_LAUNCHES.items():
        t0 = time.perf_counter()
        prompt = SERVE_PROMPT.get(arch, SERVE["prompt"])
        argv = ["--arch", arch, "--batch", str(SERVE["batch"]),
                "--prompt-len", str(prompt), "--gen",
                str(SERVE["gen"]), "--seed", "0"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fops.flash_attention.launches = 0
        sops.ssd_scan.launches = 0
        toks = serve.main(argv)
        counts = {"flash_attention": fops.flash_attention.launches,
                  "ssd_scan": sops.ssd_scan.launches}
        peak = torch.cuda.max_memory_allocated()
        launches[name] = launches.get(name, 0) + counts[name]
        serve_launches[arch] = counts[name]
        check(counts[name] == per_prefill,
              f"{arch}: serve launched {name} {counts[name]} times, not "
              f"{per_prefill} per prefill")
        check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen"] + 1)
              and toks.dtype == torch.int32, f"{arch}: tokens "
              f"{tuple(toks.shape)} {toks.dtype}")
        vocab = get_config(arch).vocab
        check(bool(((toks >= 0) & (toks < vocab)).all()),
              f"{arch}: a token outside the vocabulary")

        model = serve.load_model(arch, seed=0)
        tokens = torch.from_numpy(serve.prompts(
            model.cfg, SERVE["batch"], prompt, 0)).to(dev)
        # prefill logits four ways: kernels on / off, bf16 / f32 compute
        serving = model.cfg
        logits = {}
        for dname in ("bfloat16", "float32"):
            model.cfg = dataclasses.replace(serving,
                                            compute_dtype=dtypes[dname])
            for path, on in (("kernel", 1), ("plain", 0)):
                logits[f"{path}_{dname}"] = prefill_logits(model, tokens, on)
        model.cfg = serving
        f32 = logits["plain_float32"]
        accuracy = dict(
            kernel_vs_plain_bf16=max_err(logits["kernel_bfloat16"],
                                         logits["plain_bfloat16"]),
            kernel_vs_plain_f32=max_err(logits["kernel_float32"], f32),
            **{f"{path}_bf16_vs_f32_{stat}": fn(logits[f"{path}_bfloat16"],
                                                 f32)
               for path in ("kernel", "plain")
               for stat, fn in (("max", max_err), ("mean", mean_err))})
        toks2, stats = serve.generate(model, tokens, SERVE["gen"])
        check(torch.equal(toks2[:, :1], toks[:, :1]),
              f"{arch}: the first token differs between two runs")
        _, caches = model.prefill(tokens)
        tok = toks2[:, :1].to(dev)
        serve_rows[arch] = dict(
            launches=counts, accuracy=accuracy, f32_tol=CARD_VS_CPU["tol"],
            prefill_ms=1e3 * stats["prefill_s"],
            decode_ms_per_token=1e3 * stats["decode_s"] / SERVE["gen"],
            tokens_per_s=SERVE["batch"] * SERVE["gen"] / stats["decode_s"],
            peak_memory_gb=peak / 1e9, sample=toks[0, :8].tolist(),
            decode_profile=decode_profile(torch, model, caches, tok, prompt))
        emit("serve", arch=arch, **serve_rows[arch],
             batch=SERVE["batch"], prompt=prompt, gen=SERVE["gen"],
             compute_dtype="bfloat16", nvidia_smi=smi,
             seconds=round(time.perf_counter() - t0, 3))
        # at full depth the kernels compute their plain versions' function
        # (f32), and serving in bf16 through them is no further from the
        # f32 logits than the plain bf16 path (the bf16 paths differ from
        # each other by their own rounding, above SERVE_TOL at this depth)
        check_close(torch, logits["kernel_float32"], f32, CARD_VS_CPU["tol"],
                    f"{arch} full-depth f32 prefill, kernel vs plain")
        for stat in ("max", "mean"):
            k = accuracy[f"kernel_bf16_vs_f32_{stat}"]
            p = accuracy[f"plain_bf16_vs_f32_{stat}"]
            check(k <= BF16_MARGIN * p, f"{arch}: bf16 kernel path is "
                  f"{k} from the f32 logits ({stat}), the plain path {p}")
        del model, logits, f32, caches
        torch.cuda.empty_cache()

    # ---- timing at the serving shapes --------------------------------------
    flash_call = lambda q, k, v: fops.flash_attention(q, k, v, causal=True)
    ssd_call = lambda *a: sops.ssd_scan(*a, chunk=SSD_PATH["chunk"])
    f32_bound = (flash_bound(torch, *f32_flash),
                 ssd_bound(*f32_ssd, SSD_PATH["chunk"]))
    emit("lm_timing_f32", nvidia_smi=smi, samples=LM_TIMING_SAMPLES,
         launches_per_sample=2,
         flash_attention=dict(
             shape=list(f32_flash[0].shape), kernel_ms=time_ms(
                 torch, lambda: flash_call(*f32_flash), LM_TIMING_SAMPLES, 2),
             bound_ms=f32_bound[0][0], bound_by=f32_bound[0][1],
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu"),
         ssd_scan=dict(
             shape=dict(SSD_PATH), kernel_ms=time_ms(
                 torch, lambda: ssd_call(*f32_ssd), LM_TIMING_SAMPLES, 2),
             bound_ms=f32_bound[1][0], bound_by=f32_bound[1][1],
             source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"))
    f_bound = flash_bound(torch, fq, fk, fv)
    s_bound = ssd_bound(*ssd_args, SSD_PATH["chunk"])
    flash_ms = time_ms(torch, lambda: flash_call(fq, fk, fv),
                       LM_TIMING_SAMPLES, 5)
    flash_plain_ms = time_ms(torch, lambda: fops.flash_attention_plain(
        fq, fk, fv, causal=True), LM_TIMING_SAMPLES, 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (fq, fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_library_ms = time_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=True, enable_gqa=True), LM_TIMING_SAMPLES, 5)
    # without the causal mask (twice the work, no diagonal tiles, every q
    # tile equally heavy) beside SDPA: what the causal structure costs
    full_bound = flash_bound(torch, fq, fk, fv, causal=False)
    flash_full_ms = time_ms(torch, lambda: fops.flash_attention(
        fq, fk, fv, causal=False), LM_TIMING_SAMPLES, 5)
    library_full_ms = time_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=False, enable_gqa=True), LM_TIMING_SAMPLES, 5)
    ssd_ms = time_ms(torch, lambda: ssd_call(*ssd_args), LM_TIMING_SAMPLES, 5)
    ssd_plain_ms = time_ms(torch, lambda: sops.ssd_ref(
        *ssd_args, SSD_PATH["chunk"]), LM_TIMING_SAMPLES, 5)
    emit("lm_timing", nvidia_smi=smi, samples=LM_TIMING_SAMPLES,
         launches_per_sample=5,
         flash_attention=dict(
             shape=list(fq.shape), kv_heads=FLASH_PATH["kv"],
             dtype="bfloat16", causal=True, kernel_ms=flash_ms,
             plain_ms=flash_plain_ms, bound_ms=f_bound[0],
             bound_by=f_bound[1], bytes=f_bound[2], flops=f_bound[3],
             library_ms=flash_library_ms,
             library="scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True)",
             noncausal=dict(kernel_ms=flash_full_ms,
                            library_ms=library_full_ms,
                            bound_ms=full_bound[0], flops=full_bound[3])),
         ssd_scan=dict(
             shape=dict(SSD_PATH), dtype="bfloat16", kernel_ms=ssd_ms,
             plain_ms=ssd_plain_ms, bound_ms=s_bound[0],
             bound_by=s_bound[1], bytes=s_bound[2], flops=s_bound[3],
             library_ms=None,
             library_note="no single PyTorch call computes the SSD scan"))

    # gemma3-1b's prefill shape, both routes: global layers (causal) and
    # local ones (window 1024) beside SDPA at the global layers' shape
    gemma_rows = {}
    for dname in dtypes:
        gq, gk, gv = gemma_flash[dname]
        row = dict(shape=list(gq.shape), kv_heads=gp["kv"],
                   window=gp["window"])
        for label, window in (("global", None), ("local", gp["window"])):
            b_ = flash_bound(torch, gq, gk, gv, window=window)
            row[label] = dict(
                kernel_ms=time_ms(torch, lambda: fops.flash_attention(
                    gq, gk, gv, causal=True, window=window),
                    LM_TIMING_SAMPLES, 5),
                plain_ms=time_ms(torch, lambda: fops.flash_attention_plain(
                    gq, gk, gv, causal=True, window=window),
                    LM_TIMING_SAMPLES, 2),
                bound_ms=b_[0], bound_by=b_[1], bytes=b_[2], flops=b_[3])
        gqt, gkt, gvt = (x.transpose(1, 2).contiguous() for x in (gq, gk, gv))
        row["global"]["library_ms"] = time_ms(torch, lambda: sdpa(
            gqt, gkt, gvt, is_causal=True, enable_gqa=True),
            LM_TIMING_SAMPLES, 5)
        gemma_rows[dname] = row
        del gqt, gkt, gvt
    emit("lm_timing_hd256", nvidia_smi=smi, samples=LM_TIMING_SAMPLES,
         library="scaled_dot_product_attention(is_causal=True, "
                 "enable_gqa=True), global layers",
         **gemma_rows)

    # the families' prefill shapes, bf16 (the serving dtype): device ms per
    # call (graph replay), CUDA-event ms, plain ms and the bound, SDPA beside
    # flash attention
    fam_timing = {}
    for arch, (q, k, v) in fam_flash.items():
        b_ = flash_bound(torch, q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fam_timing[f"flash_attention {arch}"] = dict(
            shape=list(q.shape), kv_heads=FAMILY_FLASH[arch]["kv"],
            ms=ablate.graph_ms(lambda: flash_call(q, k, v),
                               samples=LM_TIMING_SAMPLES),
            events_ms=time_ms(torch, lambda: flash_call(q, k, v),
                              LM_TIMING_SAMPLES, 5),
            plain_ms=time_ms(torch, lambda: fops.flash_attention_plain(
                q, k, v, causal=True), LM_TIMING_SAMPLES, 2),
            bound_ms=b_[0], bound_by=b_[1], bytes=b_[2], flops=b_[3],
            library_ms=time_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True),
                LM_TIMING_SAMPLES, 5))
        del qt, kt, vt
    for arch, args in fam_ssd.items():
        chunk = FAMILY_SSD[arch]["chunk"]
        b_ = ssd_bound(*args, chunk)
        fam_timing[f"ssd_scan {arch}"] = dict(
            shape=dict(FAMILY_SSD[arch]),
            ms=ablate.graph_ms(lambda: sops.ssd_scan(*args, chunk=chunk),
                               samples=LM_TIMING_SAMPLES),
            events_ms=time_ms(torch, lambda: sops.ssd_scan(*args,
                                                           chunk=chunk),
                              LM_TIMING_SAMPLES, 5),
            plain_ms=time_ms(torch, lambda: sops.ssd_ref(*args, chunk),
                             LM_TIMING_SAMPLES, 2),
            bound_ms=b_[0], bound_by=b_[1], bytes=b_[2], flops=b_[3],
            library_ms=None)
    emit("lm_timing_families", nvidia_smi=smi, samples=LM_TIMING_SAMPLES,
         dtype="bfloat16", library="scaled_dot_product_attention("
         "is_causal=True, enable_gqa=True)", **fam_timing)

    # ---- profile: device time per wrapper call, decode idle share ----------
    gw = gp["window"]
    calls = {"flash_attention_bf16": lambda: flash_call(fq, fk, fv),
             "flash_attention_f32": lambda: flash_call(*f32_flash),
             "flash_attention_bf16_hd256": lambda: flash_call(
                 *gemma_flash["bfloat16"]),
             "flash_attention_bf16_hd256_window": lambda: fops.flash_attention(
                 *gemma_flash["bfloat16"], causal=True, window=gw),
             "flash_attention_f32_hd256": lambda: flash_call(
                 *gemma_flash["float32"]),
             "flash_attention_f32_hd256_window": lambda: fops.flash_attention(
                 *gemma_flash["float32"], causal=True, window=gw),
             "ssd_scan_bf16": lambda: ssd_call(*ssd_args),
             "ssd_scan_f32": lambda: ssd_call(*f32_ssd)}
    per_call = {name: wrapper_device_ms(torch, fn) for name, fn in
                calls.items()}
    # device ms per call with no host work between calls (a CUDA graph of
    # back-to-back calls), which the profiler's misses do not affect
    graph = {name: ablate.graph_ms(fn, samples=LM_TIMING_SAMPLES)
             for name, fn in calls.items()}
    emit("lm_profile",
         device_ms_per_call={k: v[0] for k, v in per_call.items()},
         graph_ms_per_call=graph,
         device_ms_per_kernel={k: v[1] for k, v in per_call.items()},
         decode={arch: row["decode_profile"]
                 for arch, row in serve_rows.items()})
    return [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bf16.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:28",
             launches=launches["flash_attention"],
             launches_by_arch={a: serve_launches[a] for a, (n, _) in
                               SERVE_LAUNCHES.items()
                               if n == "flash_attention"},
             max_abs_err=flash_err,
             ms=graph["flash_attention_bf16"],
             profiler_ms=per_call["flash_attention_bf16"][0],
             events_ms=flash_ms,
             plain_ms=flash_plain_ms, bound_ms=f_bound[0],
             bound_by=f_bound[1], library_ms=flash_library_ms,
             hd256=dict(
                 shape=gemma_rows["bfloat16"]["shape"], kv_heads=gp["kv"],
                 launches=serve_launches["gemma3-1b"],
                 max_abs_err=gemma_errs,
                 **{f"{d}_{layer}": dict(
                     ms=graph[f"flash_attention_{ROUTE[d]}_hd256"
                              + ("_window" if layer == "local" else "")],
                     **gemma_rows[d][layer])
                    for d in ("bfloat16", "float32")
                    for layer in ("global", "local")}),
             families={a: row for a, row in fam_timing.items()
                       if a.startswith("flash_attention")},
             routes={"bfloat16": "cuda, wgmma + TMA: flash_attention_bf16.cu",
                     "float32": "cuda, CUDA-core FMA: flash_attention.cu"}),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bf16.cu",
             replaces="src/repro/kernels/ssd_scan/ssd_scan.py:26",
             launches=launches["ssd_scan"], max_abs_err=ssd_err,
             ms=graph["ssd_scan_bf16"],
             profiler_ms=per_call["ssd_scan_bf16"][0],
             events_ms=ssd_ms,
             plain_ms=ssd_plain_ms, bound_ms=s_bound[0], bound_by=s_bound[1],
             library_ms=None,
             families={a: row for a, row in fam_timing.items()
                       if a.startswith("ssd_scan")},
             routes={"bfloat16": "cuda, mma.sync bf16 + split TF32, four "
                                 "kernels: ssd_scan_bf16.cu",
                     "float32": "cuda, CUDA-core FMA: ssd_scan.cu"})]


# ---------------------------------------------------------------------------
# LM training path: qwen3-1.7b, loss and backward, AdamW, data, checkpoints,
# the train driver; no kernel runs on it
# ---------------------------------------------------------------------------

def close(a, b, tol) -> bool:
    return abs(a - b) <= tol + tol * abs(b)


def train_smoke_model(torch, Model, cfg, dev):
    """The parity run's model: `cfg` holding `train_smoke_params`."""
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    flat = train_smoke_params([(n, tuple(p.shape))
                               for n, p in model.named_parameters()],
                              TRAIN_SMOKE["seed"])
    model.load_state_dict({n: torch.from_numpy(a) for n, a in flat.items()})
    return model.to(dev)


def max_state_diff(a, b) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[n].cpu() - sb[n].cpu()).abs().max()) for n in sa)


def train_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs of one trained token (forward + backward, 3 forward
    passes, recomputation not counted): 2 per multiply-add of the layers'
    products, of the causal attention products (QKᵀ and PV over the
    (seq + 1) / 2 keys a query sees on average) and of the vocab head."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    layer = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f) \
        + 2 * 2 * h * hd * (seq + 1) / 2
    return 3 * (cfg.n_layers * layer + 2 * d * cfg.vocab)


def expect_no_backward(fn, what: str) -> str:
    try:
        fn()
    except RuntimeError as e:
        check("no backward" in str(e), f"{what}: raised {e}")
        return str(e)
    raise RuntimeError(f"check failed: {what} ran with grad enabled")


def train_phase(torch, dev, smi, fops, sops) -> list:
    """The training phases: (a) `train_parity`, (b) `train_card_vs_cpu`,
    (c) `train_full` and `train_remat_memory`, (d) `train_kernels`.
    Returns `train_full`'s losses."""
    import os
    import shutil
    import statistics
    import tempfile

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as St
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, adamw_update

    kernel_launches = (fops.flash_attention.launches, sops.ssd_scan.launches)

    def on(batch, device):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    # ---- (a) the smoke config against the JAX table ------------------------
    t0 = time.perf_counter()
    ts = TRAIN_SMOKE
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=True),
                              compute_dtype=torch.float32)
    argv = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(ts["steps"]),
            "--batch", str(ts["batch"]), "--seq", str(ts["seq"]), "--seed",
            str(ts["seed"]), "--log-every", "100"]
    with tempfile.TemporaryDirectory() as ck:
        ck_argv = argv + ["--ckpt-dir", ck, "--ckpt-every",
                          str(ts["ckpt_every"])]
        whole_model = train_smoke_model(torch, Model, cfg, dev)
        whole = train.run(train.parse_args(ck_argv), model=whole_model)
        mb2 = train.run(train.parse_args(argv + ["--microbatches", "2"]),
                        model=train_smoke_model(torch, Model, cfg, dev))
        # stopped after the step-4 checkpoint, resumed in a fresh model and
        # optimizer
        shutil.rmtree(os.path.join(ck, f"step_{ts['steps']:08d}"))
        resumed_model = train_smoke_model(torch, Model, cfg, dev)
        resumed = train.run(train.parse_args(ck_argv), model=resumed_model)
    errs = {}
    for label, recs, suffix in (("whole", whole, ""), ("microbatches_2", mb2,
                                                       "_mb2")):
        check([r["step"] for r in recs] == list(range(ts["steps"])),
              f"train {label}: steps {[r['step'] for r in recs]}")
        for key in ("loss", "grad_norm"):
            want = REFERENCE_TRAIN[key + suffix]
            got = [r[key] for r in recs]
            check(all(close(g, w, TRAIN_TOL) for g, w in zip(got, want)),
                  f"train {label} {key} {got} != JAX {want}")
            errs[f"{label}_{key}"] = max(abs(g - w) for g, w in zip(got,
                                                                   want))
    check([r["step"] for r in resumed] == list(range(ts["ckpt_every"],
                                                      ts["steps"])),
          f"resumed steps {[r['step'] for r in resumed]}")
    tail = whole[ts["ckpt_every"]:]
    resume_err = max(abs(a[key] - b[key]) for a, b in zip(tail, resumed)
                     for key in ("loss", "grad_norm"))
    resume_param_err = max_state_diff(whole_model, resumed_model)
    check(resume_err <= 1e-6 and resume_param_err <= 1e-6,
          f"resumed run differs from the uninterrupted one: {resume_err}, "
          f"parameters {resume_param_err}")
    emit("train_parity", arch=TRAIN_ARCH, config="smoke",
         compute_dtype="float32", **ts, tol=TRAIN_TOL,
         loss=[r["loss"] for r in whole],
         grad_norm=[r["grad_norm"] for r in whole], max_abs_err_vs_jax=errs,
         resumed_steps=[r["step"] for r in resumed],
         resumed_max_abs_err=resume_err,
         resumed_param_max_abs_err=resume_param_err,
         resumed_bitwise=resume_err == 0 and resume_param_err == 0,
         seconds=round(time.perf_counter() - t0, 3))
    del whole_model, resumed_model

    # ---- (b) full width, depth 2, f32: the card against the CPU ------------
    t0 = time.perf_counter()
    tw = TRAIN_WIDE
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=tw["depth"],
                              compute_dtype=torch.float32)
    cpu_model = Model(cfg).init(torch.Generator().manual_seed(0))
    start = copy.deepcopy(cpu_model.state_dict())
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=tw["seq"],
                            global_batch=tw["batch"], seed=0).batch(0)
    out = {}
    for label, model in (("card", card_model), ("cpu", cpu_model)):
        step = St.make_train_step(model, St.TrainConfig(
            warmup_steps=tw["warmup"]))
        t1 = time.perf_counter()
        loss, gnorm = step(adamw_init(model.param_tree()),
                           on(batch, model.device))
        out[label] = dict(loss=float(loss), grad_norm=float(gnorm),
                          seconds=time.perf_counter() - t1)
    param_err = max_state_diff(card_model, cpu_model)
    moved = max(float((p - start[n]).abs().max())
                for n, p in cpu_model.state_dict().items())
    for key in ("loss", "grad_norm"):
        check(close(out["card"][key], out["cpu"][key], tw["tol"]),
              f"full width {key}: card {out['card'][key]} cpu "
              f"{out['cpu'][key]}")
    check(param_err <= tw["tol"], f"full width: updated parameters differ "
          f"by {param_err} between the card and the CPU")
    # a step that changed nothing would differ from the CPU's by `moved`
    check(moved > tw["tol"], f"full width: the step moved no parameter by "
          f"more than {moved}")
    emit("train_card_vs_cpu", arch=TRAIN_ARCH, d_model=cfg.d_model,
         vocab=cfg.vocab, head_dim=cfg.hd, depth=tw["depth"],
         batch=tw["batch"], seq=tw["seq"], compute_dtype="float32",
         remat=cfg.remat, tol=tw["tol"], card=out["card"], cpu=out["cpu"],
         param_max_abs_err=param_err, param_max_abs_change=moved,
         seconds=round(time.perf_counter() - t0, 3))
    del cpu_model, card_model, start
    torch.cuda.empty_cache()

    # ---- (c) full width and depth, bf16, remat "full": the driver ----------
    t0 = time.perf_counter()
    tf = TRAIN_FULL
    args = train.parse_args(["--arch", TRAIN_ARCH, "--batch",
                             str(tf["batch"]), "--seq", str(tf["seq"]),
                             "--steps", str(tf["steps"]), "--log-every", "1"])
    model = train.build_model(args)
    cfg = model.cfg
    check(cfg.compute_dtype == torch.bfloat16 and cfg.remat == "full"
          and not cfg.use_flash_kernel and not cfg.use_ssd_kernel,
          f"{TRAIN_ARCH}'s config: {cfg.compute_dtype}, remat {cfg.remat}")
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=tf["seq"],
                           global_batch=tf["batch"], seed=args.seed)
    batch0 = on(data.batch(0), dev)
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    with torch.no_grad():
        f32_loss = float(model.loss_fn(model.param_tree(), batch0))
    model.cfg = cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    records = train.run(args, model=model)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records]
    check(len(losses) == tf["steps"] and all(math.isfinite(x) for x in losses),
          f"driver losses {losses}")
    check(abs(losses[0] - f32_loss) <= tf["f32_loss_tol"],
          f"first bf16 step's loss {losses[0]} is not within "
          f"{tf['f32_loss_tol']} of the f32 forward's {f32_loss}")
    step_s = statistics.median(r["seconds"]
                               for r in records[tf["warm_steps"]:])
    tokens = tf["batch"] * tf["seq"]
    flops = train_flops_per_token(cfg, tf["seq"]) * tokens

    # device launches and idle share of whole steps, and the update alone
    tcfg = St.TrainConfig(total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    step = St.make_train_step(model, tcfg)
    opt = adamw_init(model.param_tree())
    float(step(opt, batch0)[0])
    torch.cuda.synchronize()
    step_profile = profile_cycles(
        torch, lambda: [float(step(opt, batch0)[0])
                        for _ in range(tf["profile_steps"])],
        tf["profile_steps"])
    grads = T.tree_map(lambda p: torch.full_like(p, 1e-3,
                                                 dtype=cfg.compute_dtype),
                       model.param_tree())
    update = lambda: adamw_update(tcfg.opt, model.param_tree(), grads, opt,
                                  0.5)
    opt_ms = time_ms(torch, update, tf["opt_samples"], 1)
    opt_profile = profile_cycles(torch, update, 1)
    del step, opt, grads, update
    emit("train_full", arch=TRAIN_ARCH, via="launch.train.run (main's loop)",
         d_model=cfg.d_model, n_layers=cfg.n_layers, vocab=cfg.vocab,
         params=sum(p.numel() for p in model.parameters()),
         batch=tf["batch"], seq=tf["seq"], steps=tf["steps"],
         compute_dtype="bfloat16", remat=cfg.remat, losses=losses,
         grad_norms=[r["grad_norm"] for r in records],
         f32_first_loss=f32_loss, first_loss_vs_f32=losses[0] - f32_loss,
         step_seconds=[r["seconds"] for r in records],
         median_step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops, model_tflops_per_s=flops / step_s / 1e12,
         bf16_peak_tflops=PEAK_FLOPS["bfloat16"] / 1e12,
         mfu=flops / step_s / PEAK_FLOPS["bfloat16"],
         peak_memory_gb=peak / 1e9,
         device_launches_per_step=step_profile["device_launches_per_cycle"],
         device_idle_share=step_profile["device_idle_share"],
         device_idle_share_of_unprofiled_step=1 - (
             step_profile["device_busy_s"] or 0) / tf["profile_steps"]
         / step_s,
         profiled_wall_s_per_step=step_profile["wall_s"] / tf["profile_steps"],
         device_busy_s_per_step=(step_profile["device_busy_s"] or 0)
         / tf["profile_steps"],
         top_device_us_per_step=step_profile["top_device_us"],
         optimizer_update_ms=opt_ms,
         optimizer_device_launches=opt_profile["device_launches_per_cycle"],
         optimizer_device_ms=1e3 * (opt_profile["device_busy_s"] or 0),
         nvidia_smi=smi, seconds=round(time.perf_counter() - t0, 3))
    del model
    torch.cuda.empty_cache()

    # the loss falls on one fixed batch (tests/test_models.py), then one step
    # of each remat mode at batch 1 for its peak memory
    t0 = time.perf_counter()
    model = train.build_model(args)
    step = St.make_train_step(model, St.TrainConfig(
        total_steps=50, warmup_steps=tf["descent_warmup"]))
    opt = adamw_init(model.param_tree())
    descent = [float(step(opt, batch0)[0])
               for _ in range(tf["descent_steps"])]
    check(descent[-1] < descent[0] - tf["min_fall"],
          f"the loss fell from {descent[0]} to {descent[-1]} in "
          f"{tf['descent_steps']} steps on one batch")
    one = {k: v[:tf["remat_batch"]] for k, v in batch0.items()}
    remat_rows = {}
    for remat in ("full", "dots", "none"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        # the loss and its gradient alone (the step's first half, where the
        # modes differ), then a whole step (the optimizer's temporaries)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        leaves = [p.detach().to(cfg.compute_dtype).requires_grad_()
                  for p in T.leaves(model.param_tree())]
        grads = torch.autograd.grad(model.loss_fn(
            T.unflatten(model.param_tree(), leaves), one), leaves)
        torch.cuda.synchronize()
        backward_peak = torch.cuda.max_memory_allocated()
        del leaves, grads
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        loss = float(step(opt, one)[0])
        remat_rows[remat] = dict(
            loss=loss, first_step_ms_after_empty_cache=1e3 * (
                time.perf_counter() - t1),
            loss_and_grad_peak_memory_gb=backward_peak / 1e9,
            step_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(math.isfinite(loss), f"remat {remat}: loss {loss}")
    model.cfg = cfg
    emit("train_remat_memory", arch=TRAIN_ARCH, descent_losses=descent,
         descent_fall=descent[0] - descent[-1], min_fall=tf["min_fall"],
         descent_warmup=tf["descent_warmup"], batch=tf["remat_batch"],
         seq=tf["seq"], modes=remat_rows, nvidia_smi=smi,
         seconds=round(time.perf_counter() - t0, 3))

    # ---- (d) the kernels stay off the training path ------------------------
    t0 = time.perf_counter()
    raised = {}
    q = torch.randn((1, tf["seq"], cfg.n_heads, cfg.hd), device=dev,
                    dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn((1, tf["seq"], cfg.n_kv_heads, cfg.hd), device=dev,
                     dtype=torch.bfloat16)
    raised["flash_attention"] = expect_no_backward(
        lambda: fops.flash_attention(q, kv, kv), "flash_attention")
    sp = SSD_PATH
    x = torch.randn((1, sp["t"], 2, sp["p"]), device=dev,
                    dtype=torch.bfloat16, requires_grad=True)
    dt = torch.rand((1, sp["t"], 2), device=dev) * 0.85 + 0.05
    a = -torch.rand((2,), device=dev) - 0.3
    bm = torch.randn((1, sp["t"], sp["n"]), device=dev, dtype=torch.bfloat16)
    raised["ssd_scan"] = expect_no_backward(
        lambda: sops.ssd_scan(x, dt, a, bm, bm, chunk=sp["chunk"]),
        "ssd_scan")
    model.cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    raised["qwen3_loss_with_flash"] = expect_no_backward(
        lambda: step(opt, one), f"{TRAIN_ARCH} train step with "
        f"use_flash_kernel")
    del model, step, opt
    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                               use_ssd_kernel=True, ssm_chunk=16)
    mamba = Model(mcfg).init(torch.Generator(device=dev).manual_seed(0))
    mb = on(SyntheticLMData(vocab=mcfg.vocab, seq_len=32, global_batch=2,
                            seed=0).batch(0), dev)
    raised["mamba2_loss_with_ssd"] = expect_no_backward(
        lambda: St.make_train_step(mamba, St.TrainConfig())(
            adamw_init(mamba.param_tree()), mb),
        "mamba2 train step with use_ssd_kernel")
    launched = (fops.flash_attention.launches - kernel_launches[0],
                sops.ssd_scan.launches - kernel_launches[1])
    check(launched == (0, 0), f"the training phases launched kernels: "
          f"flash {launched[0]}, SSD {launched[1]}")
    emit("train_kernels", raised=raised,
         kernel_launches_in_training={"flash_attention": launched[0],
                                      "ssd_scan": launched[1]},
         seconds=round(time.perf_counter() - t0, 3))
    return losses


# ---------------------------------------------------------------------------
# the model families: MLA, the encoder-decoder, MoE and the hybrid
# ---------------------------------------------------------------------------

def families_parity_rows(torch, dev) -> dict:
    """The numbers REFERENCE_FAMILIES holds, from the port on `dev` (it
    runs on the CPU too): each family's smoke config at float32 compute
    holding `train_smoke_params`, prefill and two decode steps on
    `family_inputs`, then one step of the train driver's loop."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model

    fs = FAMILIES_SMOKE
    rows = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=torch.float32)
        model = train_smoke_model(torch, Model, cfg, dev)
        toks, frames, steps = family_inputs(cfg)
        logits, caches = model.prefill(
            torch.from_numpy(toks).to(dev),
            None if frames is None else torch.from_numpy(frames).to(dev))
        out = [logits_summary(logits.float().cpu().numpy())]
        for i in range(fs["decode"]):
            logits, caches = model.decode_step(
                caches, torch.from_numpy(steps[i]).to(dev), fs["prompt"] + i)
            out.append(logits_summary(logits[:, -1].float().cpu().numpy()))
        rec = train.run(train.parse_args(
            ["--arch", arch, "--smoke", "--steps", "1", "--batch",
             str(fs["train_batch"]), "--seq", str(fs["train_seq"]), "--seed",
             str(fs["seed"]), "--log-every", "100"]), model=model)[0]
        rows[arch] = dict(prefill=out[0], decode=out[1:], loss=rec["loss"],
                          grad_norm=rec["grad_norm"])
    return rows


def host_waits(torch, fn) -> int:
    """Times the host waits for the card while `fn()` runs, as the
    simulator's sync watch (`simulator.log_ops`) marks them."""
    from repro_torch.core.simulator import log_ops
    torch.cuda.synchronize()
    with log_ops({}) as log:
        fn()
    return sum(1 for op in log if op.synced)


def decode_profile(torch, model, caches, tok, start: int) -> dict:
    """torch.profiler over DECODE_PROFILE_STEPS decode steps from `caches`:
    wall s, device busy s, idle share, device launches per token and the
    top device kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(DECODE_PROFILE_STEPS):
            _, caches = model.decode_step(caches, tok, start + i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
    events = device_rows(prof)
    busy_s = sum(device_us(e) for e in events) / 1e6
    return dict(
        steps=DECODE_PROFILE_STEPS, wall_s=wall_s,
        device_busy_s=busy_s if busy_s > 0 else None,
        device_idle_share=(1 - busy_s / wall_s) if busy_s > 0 else None,
        device_launches_per_token=sum(e.count for e in events)
        / DECODE_PROFILE_STEPS if busy_s > 0 else None,
        top_device_us_per_token={
            e.key[:60]: device_us(e) / DECODE_PROFILE_STEPS
            for e in sorted(events, key=device_us, reverse=True)[:6]})


def families_phase(torch, dev, smi, fops, sops, serve) -> dict:
    """The families' phases: `families_parity`, `moe_vs_plain`,
    `families_kernel_vs_plain` (with the card against the CPU) and
    `families_serve`.  Returns the serving runs' flash and SSD launches
    per config."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import layers as L

    # ---- (a) the smoke configs against the JAX table -----------------------
    t0 = time.perf_counter()
    rows = families_parity_rows(torch, dev)
    errs = {}
    for arch, row in rows.items():
        got, want = numbers(row), numbers(REFERENCE_FAMILIES[arch])
        check(len(got) == len(want) and all(
            close(g, w, FAMILIES_TOL) for g, w in zip(got, want)),
            f"families_parity {arch}: {row} != JAX {REFERENCE_FAMILIES[arch]}")
        errs[arch] = max(abs(g - w) for g, w in zip(got, want))
    emit("families_parity", compute_dtype="float32", max_abs_err=errs,
         tol=FAMILIES_TOL, loss={a: r["loss"] for a, r in rows.items()},
         grad_norm={a: r["grad_norm"] for a, r in rows.items()},
         seconds=round(time.perf_counter() - t0, 3))

    # ---- (b) the card's grouped MoE product against the per-expert loop ----
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(20)
    moe_rows = {}
    for arch in MOE_CHECK:
        cfg = get_config(arch)
        params = {k: v.to(bf16) for k, v in L.init_moe(gen, cfg,
                                                       bf16).items()}
        row = {}
        for label, t in (("prefill", SERVE["prompt"]), ("decode", 1)):
            x = torch.randn((SERVE["batch"], t, cfg.d_model), generator=gen,
                            device=dev).to(bf16)
            check(L.moe_route(x) == "grouped", f"{arch}: bf16 on the card "
                  f"takes route {L.moe_route(x)}")
            run = {route: (lambda route=route: L.moe_ragged(
                params, x, cfg, route=route)) for route in ("grouped",
                                                            "loop")}
            (yg, ag), (yl, al) = run["grouped"](), run["loop"]()
            check(float(ag) == float(al), f"{arch} {label}: aux {ag} {al}")
            row[label] = dict(
                tokens=SERVE["batch"] * t,
                max_abs_err=check_close(torch, yg, yl, MOE_TOL,
                                        f"moe {arch} {label}"),
                grouped_ms=time_ms(torch, run["grouped"], LM_TIMING_SAMPLES,
                                   2),
                loop_ms=time_ms(torch, run["loop"], LM_TIMING_SAMPLES, 2),
                host_waits={route: host_waits(torch, fn)
                            for route, fn in run.items()})
        moe_rows[arch] = dict(experts=cfg.n_experts, top_k=cfg.top_k,
                              d_model=cfg.d_model, d_ff=cfg.d_ff, **row)
        del params, run, x, yg, yl
        torch.cuda.empty_cache()
    emit("moe_vs_plain", nvidia_smi=smi, tol=MOE_TOL, dtype="bfloat16",
         routes={"grouped": "torch._grouped_mm, offsets on the card",
                 "loop": "torch.matmul per expert segment"},
         layers=moe_rows, seconds=round(time.perf_counter() - t0, 3))

    # ---- (c) kernel against plain at f32, the card against the CPU ---------
    t0 = time.perf_counter()
    cvc = CARD_VS_CPU
    kvp = {}
    for arch in FAMILY_LAUNCHES:
        base = get_config(arch)
        depth = FAMILY_KVP_DEPTH.get(arch, cvc["depth"])
        cfg = dataclasses.replace(
            base, n_layers=depth, n_enc_layers=min(base.n_enc_layers, depth),
            compute_dtype=torch.float32, use_flash_kernel=True,
            use_ssd_kernel=True)
        on_cpu = arch in FAMILY_CARD_VS_CPU
        if on_cpu:
            cpu_model = Model(cfg).init(torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu_model).to(dev)
        else:
            card = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        toks, frames = serve.inputs(cfg, cvc["batch"], cvc["prompt"], 1)
        steps = torch.from_numpy(serve.prompts(
            cfg, cvc["decode"] * cvc["batch"], 1, 2)).view(
                cvc["decode"], cvc["batch"], 1)

        def run(model, device, kernels):
            model.cfg = dataclasses.replace(model.cfg,
                                            use_flash_kernel=kernels,
                                            use_ssd_kernel=kernels)
            logits, caches = model.prefill(
                torch.from_numpy(toks).to(device),
                None if frames is None else torch.from_numpy(frames).to(
                    device))
            outs = [logits.cpu()]
            for i in range(cvc["decode"]):
                logits, caches = model.decode_step(
                    caches, steps[i].to(device), cvc["prompt"] + i)
                outs.append(logits[:, -1].cpu())
            return outs

        before = (fops.flash_attention.launches, sops.ssd_scan.launches)
        kern = run(card, dev, True)
        launched = (fops.flash_attention.launches - before[0],
                    sops.ssd_scan.launches - before[1])
        specs = cfg.layer_specs()
        want = (sum(sp["kind"] == "attn" for sp in specs),
                sum(sp["kind"] == "mamba" for sp in specs))
        check(launched == want, f"{arch} depth {depth}: (flash, SSD) "
              f"launches {launched}, not {want}")
        plain = run(card, dev, False)
        row = dict(depth=depth, launches=dict(zip(("flash_attention",
                                                   "ssd_scan"), launched)),
                   kernel_vs_plain=[check_close(
                       torch, a, b, cvc["tol"], f"{arch} kernel vs plain "
                       f"step {i}") for i, (a, b) in enumerate(zip(kern,
                                                                  plain))])
        if on_cpu:
            cpu = run(cpu_model, torch.device("cpu"), True)
            row["kernel_vs_cpu"] = [check_close(
                torch, a, b, cvc["tol"], f"{arch} card vs cpu step {i}")
                for i, (a, b) in enumerate(zip(kern, cpu))]
            del cpu_model
        kvp[arch] = row
        del card
        torch.cuda.empty_cache()
    emit("families_kernel_vs_plain", compute_dtype="float32",
         batch=cvc["batch"], prompt=cvc["prompt"],
         decode_steps=cvc["decode"], tol=cvc["tol"], archs=kvp,
         seconds=round(time.perf_counter() - t0, 3))

    # ---- (d) serving, full width, bf16 -------------------------------------
    launches = {}
    for arch, depth in FAMILY_SERVE_DEPTH.items():
        t0 = time.perf_counter()
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=depth or base.n_layers,
                                  use_flash_kernel=True, use_ssd_kernel=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        toks, frames = serve.inputs(cfg, SERVE["batch"], SERVE["prompt"], 0)
        tokens = torch.from_numpy(toks).to(dev)
        frames = None if frames is None else torch.from_numpy(frames).to(dev)
        model.prefill(tokens, frames)             # warm-up: the bf16 copy
        torch.cuda.synchronize()
        fops.flash_attention.launches = 0
        sops.ssd_scan.launches = 0
        out, stats = serve.generate(model, tokens, SERVE["gen"], frames)
        counts = (fops.flash_attention.launches, sops.ssd_scan.launches)
        launches[arch] = counts
        check(counts == FAMILY_LAUNCHES[arch], f"{arch}: (flash, SSD) "
              f"launches {counts} per prefill, not {FAMILY_LAUNCHES[arch]}")
        check(tuple(out.shape) == (SERVE["batch"], SERVE["gen"] + 1)
              and out.dtype == torch.int32 and bool(
                  ((out >= 0) & (out < cfg.vocab)).all()),
              f"{arch}: tokens {tuple(out.shape)} {out.dtype}")
        peak = torch.cuda.max_memory_allocated()
        _, caches = model.prefill(tokens, frames)
        tok = out[:, :1].to(dev)
        waits = host_waits(torch, lambda: model.decode_step(
            caches, tok, SERVE["prompt"]))
        emit("families_serve", arch=arch, layers=cfg.n_layers,
             enc_layers=cfg.n_enc_layers, full_depth=base.n_layers,
             params=sum(p.numel() for p in model.parameters()),
             launches=dict(flash_attention=counts[0], ssd_scan=counts[1]),
             prefill_ms=1e3 * stats["prefill_s"],
             decode_ms_per_token=1e3 * stats["decode_s"] / SERVE["gen"],
             tokens_per_s=SERVE["batch"] * SERVE["gen"] / stats["decode_s"],
             peak_memory_gb=peak / 1e9, decode_host_waits_per_token=waits,
             decode_profile=decode_profile(torch, model, caches, tok,
                                           SERVE["prompt"] + 1),
             sample=out[0, :8].tolist(), batch=SERVE["batch"],
             prompt=SERVE["prompt"], gen=SERVE["gen"],
             compute_dtype="bfloat16", nvidia_smi=smi,
             seconds=round(time.perf_counter() - t0, 3))
        del model, caches
        torch.cuda.empty_cache()
    return launches


def lm_run(torch, serve, model, tokens, gen: int, forced=None) -> tuple:
    """(prefill logits [B, V], greedy tokens [B, gen + 1] through
    `serve.generate`, decode logits teacher-forced on `forced`'s tokens,
    default its own), logits float32 on the host."""
    logits = model.prefill(tokens)[0].float().cpu()
    out, _ = serve.generate(model, tokens, gen)
    return logits, out, forced_logits(torch, model, tokens,
                                      out if forced is None else forced)


def forced_logits(torch, model, tokens, out) -> list:
    """Decode logits [B, V] (float32, on the host) of each step of
    `model` fed `out`'s tokens after prefilling `tokens` (teacher
    forcing: both models of a comparison see the same inputs)."""
    _, caches = model.prefill(tokens)
    steps = []
    for i in range(out.shape[1] - 1):
        logits, caches = model.decode_step(
            caches, out[:, i:i + 1].to(tokens.device), tokens.shape[1] + i)
        steps.append(logits[:, -1].float().cpu())
    return steps


def moe_drops(torch, L, SH, stats):
    """Wrappers of the two expert-parallel bodies that add, per call, the
    (token, expert) pairs routed and those beyond each expert's capacity
    to stats[body] (host reads: for the counting pass only)."""
    def counting(fn, body):
        def wrapped(params, x, cfg, *args, **kwargs):
            _, top_e, _ = L._router({"router": SH.full(params["router"])},
                                    x, cfg)
            counts = torch.bincount(top_e.reshape(-1),
                                    minlength=cfg.n_experts)
            cap = L.moe_capacity(x.shape[0] * x.shape[1], cfg)
            row = stats.setdefault(body, dict(pairs=0, dropped=0, calls=0))
            row["pairs"] += int(counts.sum())
            row["dropped"] += int((counts - cap).clamp(min=0).sum())
            row["calls"] += 1
            return fn(params, x, cfg, *args, **kwargs)
        return wrapped
    return {"moe_ep_local": counting(L.moe_ep_local, "prefill"),
            "moe_ep_stationary": counting(L.moe_ep_stationary, "decode")}


def sharded_phase(torch, dev, smi, fops, serve) -> int:
    """The `sharded` phase; returns the sharded prefill's flash launches."""
    import shutil
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import tree as Tr
    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as SH
    from repro_torch.models.model import make_moe_apply

    t0 = time.perf_counter()
    mesh = make_host_mesh()
    ctx = St.build_ctx(mesh)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"host mesh: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    sh = SHARDED
    base = get_config(sh["arch"])
    cfg = dataclasses.replace(base, n_layers=sh["depth"],
                              use_flash_kernel=True, use_ssd_kernel=True,
                              capacity_factor=sh["dropless_cf"])
    b, t, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    tokens = torch.from_numpy(serve.prompts(cfg, b, t, 0)).to(dev)

    # ---- (a) unsharded, dropless, bf16 and f32: results to the host --------
    # The two bf16 models round differently (the MoE's products and
    # combine), and a rounding upstream can flip a near-tied expert choice
    # downstream, so the sharded model is held to the unsharded one in f32
    # (logits 1e-3, greedy tokens equal), and in bf16 layer by layer on
    # one input; the bf16 models' distances from the f32 logits and their
    # greedy tokens are reported.
    f32, bf16 = torch.float32, torch.bfloat16
    torch.cuda.empty_cache()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    runs = {"plain_bf16": lm_run(torch, serve, model, tokens, gen)}
    forced = runs["plain_bf16"][1]
    model.cfg = dataclasses.replace(cfg, compute_dtype=f32)
    runs["plain_f32"] = lm_run(torch, serve, model, tokens, gen, forced)
    del model
    torch.cuda.empty_cache()

    # ---- (b) sharded, capacity factor 16 ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, ctx).init(torch.Generator(device=dev).manual_seed(0),
                                 serving_mode="decode")
    leaves = Tr.leaves(model.param_tree())
    check(all(isinstance(p, DTensor) for p in leaves),
          "sharded model: a parameter is not a DTensor")
    serving = model.cfg
    flash_launches = {}
    for name, dt in (("sharded_f32", f32), ("sharded_bf16", bf16)):
        model.cfg = dataclasses.replace(serving, compute_dtype=dt)
        model.prefill(tokens)              # warm-up: the compute copy
        torch.cuda.synchronize()
        fops.flash_attention.launches = 0
        model.prefill(tokens)
        flash_launches[name] = fops.flash_attention.launches
        check(flash_launches[name] == sh["flash"], f"{name} prefill "
              f"launched flash {flash_launches[name]} times, not "
              f"{sh['flash']}")
        runs[name] = lm_run(torch, serve, model, tokens, gen, forced)
    model.cfg = serving
    (sp, so, ss), (pp, po, ps) = runs["sharded_f32"], runs["plain_f32"]
    f32_err = [check_close(torch, a, b_, CARD_VS_CPU["tol"],
                           f"sharded vs unsharded f32, position {i}")
               for i, (a, b_) in enumerate(zip([sp] + ss, [pp] + ps))]
    check(torch.equal(so, po), f"sharded f32 greedy tokens {so.tolist()} != "
          f"unsharded {po.tolist()}")
    ref = [pp] + ps                        # f32 logits on `forced`
    accuracy = {}
    for name in ("sharded_bf16", "plain_bf16"):
        got = [runs[name][0]] + runs[name][2]
        accuracy[name] = dict(
            prefill_max=max_err(got[0], ref[0]),
            prefill_mean=mean_err(got[0], ref[0]),
            decode_max=max(max_err(g, r) for g, r in zip(got[1:], ref[1:])),
            decode_mean=sum(mean_err(g, r) for g, r in zip(got[1:], ref[1:]))
            / len(ref[1:]))
    # the sharded bf16 model is as near the f32 logits as the unsharded
    # one, on the mean (one flipped expert choice moves a few rows, not
    # the mean)
    for key in ("prefill_mean", "decode_mean"):
        got_d, want_d = (accuracy[n][key] for n in ("sharded_bf16",
                                                    "plain_bf16"))
        check(got_d <= sh["bf16_mean_ratio"] * want_d, f"sharded bf16 "
              f"{key} distance from f32 {got_d} > {sh['bf16_mean_ratio']} x "
              f"the unsharded bf16 model's {want_d}")
    # bf16 greedy tokens: where a row first differs, the f32 logits' top-2
    # margin there (how near the tie was)
    bo, uo = runs["sharded_bf16"][1], runs["plain_bf16"][1]
    diverged = []
    for row in range(b):
        diff = (bo[row] != uo[row]).nonzero()
        if len(diff):
            j = int(diff[0])
            top2 = ref[j][row].topk(2).values
            diverged.append(dict(row=row, position=j,
                                 f32_margin=float(top2[0] - top2[1])))
    # bf16, layer by layer on the same input (no expert choice can flip):
    # the expert-parallel MoE against the unsharded one (the grouped route)
    # at the prefill and the decode token counts, within the families'
    # MoE tolerance; and their times
    moe_rows = {}
    p16 = model._cast()["layers"][0]["moe"]
    plain_p = {k: SH.full(v) for k, v in p16.items()}
    g = torch.Generator().manual_seed(22)
    for label, tt in (("prefill", t), ("decode", 1)):
        x = randn(torch, g, (b, tt, cfg.d_model), bf16, dev)
        ep = lambda x=x: make_moe_apply(model.cfg, ctx, batch=b)(p16, x)
        dense = lambda x=x: make_moe_apply(model.cfg)(plain_p, x)
        (ye, ae), (yd, ad) = ep(), dense()
        moe_rows[label] = dict(
            tokens=b * tt,
            body="moe_ep_local" if b * tt > 2048 else "moe_ep_stationary",
            max_abs_err=check_close(torch, ye, yd, MOE_TOL,
                                    f"sharded MoE {label} vs unsharded"),
            aux_err=abs(float(ae) - float(ad)),
            ep_ms=time_ms(torch, ep, LM_TIMING_SAMPLES, 2),
            grouped_ms=time_ms(torch, dense, LM_TIMING_SAMPLES, 2))
        check(moe_rows[label]["aux_err"] < 1e-5, f"sharded MoE {label} aux "
              f"{float(ae)} vs {float(ad)}")
    del p16, plain_p, x
    emit("sharded_dropless", arch=cfg.name, layers=cfg.n_layers,
         full_depth=base.n_layers, capacity_factor=cfg.capacity_factor,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
         backend=dist.get_backend(), serving_mode="decode",
         flash_launches_per_prefill=flash_launches,
         f32_max_abs_err=max(f32_err), f32_tol=CARD_VS_CPU["tol"],
         f32_tokens_equal=True, bf16_vs_f32=accuracy,
         bf16_moe_layer=moe_rows, moe_tol=MOE_TOL,
         bf16_tokens_equal=bool(torch.equal(bo, uo)),
         bf16_diverged_rows=diverged, sample=bo[0, :8].tolist(),
         seconds=round(time.perf_counter() - t0, 3))
    flash_launches = flash_launches["sharded_bf16"]
    del runs, ref

    # ---- (c) the config's capacity factor: drops, timings, counts ----------
    t1 = time.perf_counter()
    model.cfg = dataclasses.replace(model.cfg,
                                    capacity_factor=base.capacity_factor)
    stats = {}
    saved = {name: getattr(L, name) for name in ("moe_ep_local",
                                                 "moe_ep_stationary")}
    try:
        for name, fn in moe_drops(torch, L, SH, stats).items():
            setattr(L, name, fn)
        _, caches = model.prefill(tokens)
        tok = tokens[:, -1:]
        for i in range(sh["drop_decode_steps"]):
            logits, caches = model.decode_step(caches, tok, t + i)
            tok = logits[:, -1].argmax(-1)[:, None]
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)
    check(set(stats) == {"prefill", "decode"}, f"expert-parallel bodies "
          f"taken: {sorted(stats)}, not moe_ep_local in prefill and "
          f"moe_ep_stationary in decode")
    model.prefill(tokens)
    torch.cuda.synchronize()
    fops.flash_attention.launches = 0
    out, st = serve.generate(model, tokens, gen)
    serve_flash = fops.flash_attention.launches
    check(serve_flash == sh["flash"], f"sharded generate launched flash "
          f"{serve_flash} times, not {sh['flash']}")
    check(tuple(out.shape) == (b, gen + 1) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), f"sharded tokens "
          f"{tuple(out.shape)}")
    peak = torch.cuda.max_memory_allocated()
    _, caches = model.prefill(tokens)
    check(all(isinstance(c, DTensor) for c in Tr.leaves(caches)),
          "sharded caches are not DTensors")
    tok = out[:, :1].to(dev)
    waits = host_waits(torch, lambda: model.decode_step(caches, tok, t))
    check(waits == 0, f"a sharded decode step made the host wait for the "
          f"card {waits} times")
    torch.cuda.synchronize()
    with CommDebugMode() as comm:
        model.decode_step(caches, tok, t)
    torch.cuda.synchronize()
    collectives = {str(k).split(".")[-1]: v for k, v in
                   comm.get_comm_counts().items()}
    profile = decode_profile(torch, model, caches, tok, t + 1)
    emit("sharded_serve", arch=cfg.name, layers=cfg.n_layers,
         capacity_factor=base.capacity_factor,
         capacity=dict(prefill=L.moe_capacity(b * t, model.cfg),
                       decode=L.moe_capacity(b, model.cfg)),
         dropped_share={k: v["dropped"] / v["pairs"] for k, v in
                        stats.items()},
         drop_counts=stats, prefill_ms=1e3 * st["prefill_s"],
         decode_ms_per_token=1e3 * st["decode_s"] / gen,
         tokens_per_s=b * gen / st["decode_s"],
         flash_launches_per_prefill=serve_flash,
         decode_host_waits_per_token=waits,
         collectives_per_decode_step=collectives,
         decode_profile=profile, peak_memory_gb=peak / 1e9,
         params=sum(p.numel() for p in leaves), batch=b, prompt=t, gen=gen,
         compute_dtype="bfloat16", nvidia_smi=smi,
         seconds=round(time.perf_counter() - t1, 3))
    del model, caches, leaves
    torch.cuda.empty_cache()

    # ---- (d) decode_attention_dist at qwen3-1.7b's decode shape ------------
    t1 = time.perf_counter()
    dd = DIST_DECODE
    qcfg = get_config(SEQ_PARALLEL["arch"])
    g = torch.Generator().manual_seed(21)
    q = randn(torch, g, (dd["b"], 1, dd["h"], dd["hd"]), torch.float32, dev)
    kn, vn = (randn(torch, g, (dd["b"], 1, dd["kv"], dd["hd"]),
                    torch.float32, dev) for _ in range(2))
    ck, cv = (randn(torch, g, (dd["b"], dd["s"], dd["kv"], dd["hd"]),
                    torch.float32, dev) for _ in range(2))
    ck_r, cv_r = ck.clone(), cv.clone()
    ck_r[:, dd["pos"] % dd["s"]] = kn[:, 0]
    cv_r[:, dd["pos"] % dd["s"]] = vn[:, 0]
    want = L._sdpa(q, ck_r, cv_r, None)
    got, (gk, gv) = L.decode_attention_dist(None, q, kn, vn, (ck, cv),
                                            dd["pos"], qcfg, ctx)
    dist_err = check_close(torch, got, want, dd["tol"],
                           "decode_attention_dist vs dense")
    check(torch.equal(gk, ck_r) and torch.equal(gv, cv_r),
          "decode_attention_dist wrote the cache unlike the dense decode")
    emit("sharded_decode_attention", q=list(q.shape), cache=list(ck.shape),
         pos=dd["pos"], dtype="float32", max_abs_err=dist_err,
         tol=dd["tol"], cache_bit_equal=True,
         seconds=round(time.perf_counter() - t1, 3))
    del q, kn, vn, ck, cv, ck_r, cv_r, got, gk, gv, want

    # ---- (e) sequence parallelism forced on; (f) the elastic restore -------
    t1 = time.perf_counter()
    sp = SEQ_PARALLEL
    cfg = dataclasses.replace(qcfg, n_layers=sp["depth"],
                              compute_dtype=torch.float32)
    toks = torch.from_numpy(serve.prompts(cfg, sp["batch"], sp["prompt"],
                                          1)).to(dev)
    plain = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    want = plain.prefill(toks)[0].cpu()
    ckpt = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    save_checkpoint(str(ckpt), 0, plain.param_tree())
    full = Tr.tree_map(lambda p: p.detach().cpu(), plain.param_tree())
    del plain
    torch.cuda.empty_cache()
    seqp = Model(dataclasses.replace(cfg, seq_parallel=True), ctx).init(
        torch.Generator(device=dev).manual_seed(0))
    check(seqp.cfg.seq_parallel, "seq_parallel was not kept")
    seq_err = check_close(torch, seqp.prefill(toks)[0].cpu(), want,
                          sp["tol"], "seq-parallel vs unsharded prefill")
    shapes, shardings = St.param_shardings(seqp, ctx)
    del seqp
    torch.cuda.empty_cache()
    restored = restore_checkpoint(str(ckpt), 0, shapes, placements=shardings)
    n_leaves = 0
    for r, w in zip(Tr.leaves(restored), Tr.leaves(full)):
        check(isinstance(r, DTensor) and r.device.type == dev.type and
              torch.equal(r.full_tensor().cpu(), w),
              "restored parameter differs from the saved one")
        n_leaves += 1
    shutil.rmtree(ckpt, ignore_errors=True)
    emit("sharded_seq_parallel_elastic", arch=cfg.name, layers=cfg.n_layers,
         batch=sp["batch"], prompt=sp["prompt"], dtype="float32",
         seq_parallel_max_abs_err=seq_err, tol=sp["tol"],
         restored_leaves=n_leaves, restore_bit_equal=True,
         seconds=round(time.perf_counter() - t1, 3))
    del restored, full
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    emit("sharded", seconds=round(time.perf_counter() - t0, 3))
    return flash_launches


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (a DTensor taken whole)."""
    from torch.distributed.tensor import DTensor
    got = got.full_tensor() if isinstance(got, DTensor) else got
    want = want.full_tensor() if isinstance(want, DTensor) else want
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def sharded_train_phase(torch, dev, smi, fops, sops, full_losses) -> tuple:
    """The `sharded_train` phase; returns the (flash, SSD) launches it saw
    (the training path takes neither kernel)."""
    import shutil
    import statistics
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import tree as Tr
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import log_ops
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as St
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.model import make_moe_apply
    from repro_torch.optim import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    before = (fops.flash_attention.launches, sops.ssd_scan.launches)
    mesh = make_host_mesh()
    ctx = St.build_ctx(mesh)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"host mesh: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")
    st, tf = SHARDED_TRAIN, TRAIN_FULL
    f32 = torch.float32

    def on(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # ---- (a) full width, depth 2, f32: sharded against unsharded -----------
    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=st["depth"],
                              compute_dtype=f32)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=tf["seq"],
                           global_batch=tf["batch"], seed=0)
    tcfg = St.TrainConfig(total_steps=tf["steps"],
                          warmup_steps=max(tf["steps"] // 20, 5))
    models = [Model(cfg).init(torch.Generator(device=dev).manual_seed(0)),
              Model(cfg, ctx).init(torch.Generator(device=dev).manual_seed(0))]
    check(all(isinstance(p, DTensor) for p in
              Tr.leaves(models[1].param_tree())),
          "sharded train model: a parameter is not a DTensor")
    runs = [(St.make_train_step(m, tcfg), adamw_init(m.param_tree()))
            for m in models]
    check(all(isinstance(x, DTensor) for x in Tr.leaves(runs[1][1]["m"])),
          "sharded AdamW state: m is not laid out as the parameters")
    rows = []
    for i in range(st["steps"]):
        batch = on(data.batch(i))
        (lp, gp), (ls, gs) = [step(opt, batch) for step, opt in runs]
        row = dict(step=i, loss=float(ls), grad_norm=float(gs),
                   loss_rel_err=abs(float(ls) - float(lp)) / abs(float(lp)),
                   grad_norm_rel_err=abs(float(gs) - float(gp))
                   / abs(float(gp)))
        for key, get in (("params", lambda k: models[k].param_tree()),
                         ("m", lambda k: runs[k][1]["m"]),
                         ("v", lambda k: runs[k][1]["v"])):
            row[f"{key}_rel_err"] = max(
                rel_err(torch, a, b)
                for a, b in zip(Tr.leaves(get(1)), Tr.leaves(get(0))))
        for key in ("loss", "grad_norm", "params", "m", "v"):
            check(row[f"{key}_rel_err"] <= st["tol"], f"sharded train step "
                  f"{i}: {key} differs from the unsharded step by "
                  f"{row[f'{key}_rel_err']} (relative)")
        rows.append(row)
    emit("sharded_train_parity", arch=TRAIN_ARCH, d_model=cfg.d_model,
         depth=cfg.n_layers, batch=tf["batch"], seq=tf["seq"],
         compute_dtype="float32", remat=cfg.remat,
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         backend=dist.get_backend(), tol=st["tol"], steps=rows,
         seconds=round(time.perf_counter() - t1, 3))
    del models, runs
    torch.cuda.empty_cache()

    # ---- (b) full width and depth, bf16: the driver on the mesh ------------
    t1 = time.perf_counter()
    ckpt = ROOT / "build" / "sharded_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = train.parse_args([
        "--arch", TRAIN_ARCH, "--batch", str(tf["batch"]), "--seq",
        str(tf["seq"]), "--steps", str(tf["steps"]), "--log-every", "1",
        "--ckpt-dir", str(ckpt), "--ckpt-every", str(st["ckpt_every"])])
    cfg = get_config(TRAIN_ARCH)
    check(cfg.compute_dtype == torch.bfloat16 and cfg.remat == "full",
          f"{TRAIN_ARCH}'s config: {cfg.compute_dtype}, remat {cfg.remat}")
    model = Model(cfg, ctx).init(torch.Generator(device=dev).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    records = train.run(args, model=model)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, full_losses)]
    check(len(losses) == len(full_losses) == tf["steps"] and
          max(gaps) <= st["full_tol"], f"sharded driver losses {losses} vs "
          f"the unsharded {full_losses}: largest relative gap {max(gaps)}")
    step_s = statistics.median(r["seconds"]
                               for r in records[tf["warm_steps"]:])
    tokens = tf["batch"] * tf["seq"]
    flops = train_flops_per_token(cfg, tf["seq"]) * tokens
    # one step's launches, idle share, host waits and collectives
    tcfg = St.TrainConfig(opt=AdamWConfig(lr=args.lr),
                          total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    step = St.make_train_step(model, tcfg)
    opt = adamw_init(model.param_tree())
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=tf["seq"],
                           global_batch=tf["batch"], seed=args.seed)
    batch0 = on(data.batch(0))
    float(step(opt, batch0)[0])
    torch.cuda.synchronize()
    prof = profile_cycles(
        torch, lambda: [float(step(opt, batch0)[0])
                        for _ in range(st["profile_steps"])],
        st["profile_steps"])
    torch.cuda.synchronize()
    with log_ops({}) as log:
        step(opt, batch0)
    waited = [f"{op.op} at {op.synced}" for op in log if op.synced]
    torch.cuda.synchronize()
    with CommDebugMode() as comm:
        step(opt, batch0)
    torch.cuda.synchronize()
    collectives = {str(k).split(".")[-1]: v for k, v in
                   comm.get_comm_counts().items()}
    launched = (fops.flash_attention.launches - before[0],
                sops.ssd_scan.launches - before[1])
    emit("sharded_train_full", arch=TRAIN_ARCH,
         via="launch.train.run(args, model=Model(cfg, ctx))",
         mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         d_model=cfg.d_model, n_layers=cfg.n_layers, batch=tf["batch"],
         seq=tf["seq"], steps=tf["steps"], compute_dtype="bfloat16",
         remat=cfg.remat, losses=losses, unsharded_losses=full_losses,
         loss_rel_gaps=gaps, largest_loss_rel_gap=max(gaps),
         tol=st["full_tol"], grad_norms=[r["grad_norm"] for r in records],
         step_seconds=[r["seconds"] for r in records],
         median_step_ms=1e3 * step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops, mfu=flops / step_s
         / PEAK_FLOPS["bfloat16"], peak_memory_gb=peak / 1e9,
         device_launches_per_step=prof["device_launches_per_cycle"],
         device_idle_share=prof["device_idle_share"],
         device_busy_s_per_step=(prof["device_busy_s"] or 0)
         / st["profile_steps"],
         top_device_us_per_step=prof["top_device_us"],
         host_waits_per_step=len(waited), host_waits=waited,
         collectives_per_step=collectives,
         kernel_launches={"flash_attention": launched[0],
                          "ssd_scan": launched[1]},
         ckpt_every=st["ckpt_every"], nvidia_smi=smi,
         seconds=round(time.perf_counter() - t1, 3))
    check(not waited, f"a sharded train step made the host wait for the "
          f"card: {waited}")
    del model, step, opt
    torch.cuda.empty_cache()

    # ---- (d) the step-5 checkpoint, restored unsharded, takes step 6 -------
    t1 = time.perf_counter()
    k = st["ckpt_every"]
    plain = train.build_model(args)
    opt = adamw_init(plain.param_tree())
    state = restore_checkpoint(str(ckpt), k, {"params": plain.param_tree(),
                                              "opt": opt}, device=dev)
    with torch.no_grad():
        for p, q in zip(Tr.leaves(plain.param_tree()),
                        Tr.leaves(state["params"])):
            p.copy_(q)
    plain.drop_compute_copy()
    opt = state["opt"]
    del state
    loss, gnorm = St.make_train_step(plain, tcfg)(opt, on(data.batch(k)))
    resumed = (float(loss), float(gnorm))
    want = (records[k]["loss"], records[k]["grad_norm"])
    shutil.rmtree(ckpt, ignore_errors=True)
    check(resumed == want, f"step {k + 1} from the checkpoint, unsharded: "
          f"(loss, grad norm) {resumed} != the sharded run's {want}")
    emit("sharded_train_checkpoint", saved_after_step=k, restored="unsharded",
         step=k + 1, loss=resumed[0], grad_norm=resumed[1], bitwise=True,
         seconds=round(time.perf_counter() - t1, 3))
    del plain, opt
    torch.cuda.empty_cache()

    # ---- (c) one MoE layer at full width, f32: both bodies' gradients ------
    t1 = time.perf_counter()
    mcfg = dataclasses.replace(get_config(st["moe_arch"]), n_layers=1,
                               compute_dtype=f32, capacity_factor=st["moe_cf"])
    g = torch.Generator(device=dev).manual_seed(22)
    params = L.init_moe(g, mcfg)
    b, t = tf["batch"], tf["seq"]
    check(b * t > 2048, "make_moe_apply takes moe_ep_local above 2048 tokens")
    x = torch.randn((b, t, mcfg.d_model), generator=g, device=dev)
    w = torch.randn((b, t, mcfg.d_model), generator=g, device=dev)
    _, shardings = St.param_shardings(Model(mcfg, ctx), ctx)
    moe_sh = shardings["layers"][0]["moe"]
    names = ("router", "wi", "wg", "wo")

    def grads(apply, leaves):
        xg = x.detach().requires_grad_()
        y, aux = apply(dict(zip(names, leaves)), xg)
        out = torch.autograd.grad((y * w).sum() + aux, [xg] + list(leaves))
        return [o.full_tensor() if isinstance(o, DTensor) else o
                for o in out]

    want = grads(lambda p, xg: L.moe_ragged(p, xg, mcfg, route="loop"),
                 [params[n].requires_grad_() for n in names])
    dts = [DTensor.from_local(params[n].detach(), mesh,
                              moe_sh[n].placements, run_check=False)
           .requires_grad_() for n in names]
    moe_rows = {}
    for body, apply in (
            ("moe_ep_local", make_moe_apply(mcfg, ctx, batch=b)),
            ("moe_ep_stationary", lambda p, xg: L.moe_ep_stationary(
                p, xg, mcfg, ctx, batch=b))):
        got = grads(apply, dts)
        errs = {n: rel_err(torch, a, c) for n, a, c in
                zip(("x",) + names, got, want)}
        moe_rows[body] = errs
        del got
        check(max(errs.values()) <= st["moe_tol"], f"{body} gradients vs "
              f"the dropless loop route: {errs}")
    emit("sharded_train_moe", arch=mcfg.name, d_model=mcfg.d_model,
         experts=mcfg.n_experts, top_k=mcfg.top_k, d_ff=mcfg.d_ff,
         capacity_factor=mcfg.capacity_factor,
         capacity=L.moe_capacity(b * t, mcfg), tokens=b * t,
         expert_params=sum(params[n].numel() for n in names[1:]),
         compute_dtype="float32", tol=st["moe_tol"],
         grad_rel_err=moe_rows, seconds=round(time.perf_counter() - t1, 3))
    del params, dts, want, x, w
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    launched = (fops.flash_attention.launches - before[0],
                sops.ssd_scan.launches - before[1])
    check(launched == (0, 0), f"the sharded training path launched kernels: "
          f"flash {launched[0]}, SSD {launched[1]}")
    emit("sharded_train", seconds=round(time.perf_counter() - t0, 3))
    return launched


def load_example(name: str):
    """examples_torch/<name>.py as a module (its `main` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_difference(got: list, want: list) -> str:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"line {i}: {g!r} != {w!r}"
    return f"{len(got)} lines for {len(want)}"


def examples_phase(torch, smi, netstep, fops, sops) -> dict:
    """`examples`: the nine scripts of examples_torch/, each through its
    `main(argv)` in this process with no --device (the card) and --out in
    a temporary directory.  Returns the launches of netstep (the six
    simulator examples) and of flash attention (serve_lm)."""
    import contextlib
    import gc
    import io
    import os
    import statistics
    import tempfile
    from repro_torch.core import topology as T
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    seconds = {}

    def run(name, argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ret = load_example(name).main(argv)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return ret, buf.getvalue()

    with tempfile.TemporaryDirectory() as d:
        # the dry-run record for topology_collectives (fake tensors on the
        # host), made while the simulator examples run; the LM examples
        # wait for it, so that nothing else holds the host while they are
        # timed
        dry = Path(d) / "dryrun"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="2")
        t_dry = time.perf_counter()
        dryrun = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             *EXAMPLE_DRYRUN, "--out", str(dry)], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            # ---- the six simulator examples at the reference's sizes -----
            out = Path(d) / "out"
            sim_launches = {}
            netstep.launches = 0
            for script, files in SIM_EXAMPLES.items():
                before = netstep.launches
                _, text = run(script, ["--out", str(out)])
                sim_launches[script] = netstep.launches - before
                lines = example_lines(text, str(out))
                want = REFERENCE_EXAMPLES["lines"][script]
                check(lines == want, f"{script} printed lines differ from "
                      f"the reference's: {first_difference(lines, want)}")
                for name in files:
                    got = file_digest(out / name)
                    check(got == REFERENCE_EXAMPLES["files"][name],
                          f"{script}: {name} has SHA-256 {got}, the "
                          f"reference's {REFERENCE_EXAMPLES['files'][name]}")
                check(sim_launches[script] > 0,
                      f"{script} launched no netstep kernel")
            netstep_launches = netstep.launches
            # synth's registered generator is process-wide state (obs
            # switches its span tracing off itself)
            T.unregister_topology("double_ring")
            t_wait = time.perf_counter()
            log, _ = dryrun.communicate(timeout=900)
            dry_s = time.perf_counter() - t_dry
            dry_wait_s = time.perf_counter() - t_wait
            check(dryrun.returncode == 0,
                  f"the dry-run failed: {log[-2000:]}")

            # ---- serve_lm at full width: the card, 28 flash launches -----
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fops.flash_attention.launches = 0
            sops.ssd_scan.launches = 0
            toks, text = run("serve_lm", EXAMPLE_SERVE)
            serve_peak = torch.cuda.max_memory_allocated()
            flash = fops.flash_attention.launches
            per_prefill = SERVE_LAUNCHES["qwen3-1.7b"][1]
            check(flash == per_prefill and sops.ssd_scan.launches == 0,
                  f"serve_lm launched flash {flash} times (SSD "
                  f"{sops.ssd_scan.launches}), not {per_prefill} per prefill")
            serve_lines = text.splitlines()
            model_line = serve_lines[0]
            check(re.match(r"\[serve\] \S+ on cuda(:\d+)?: prefill ",
                           model_line), f"serve_lm's model line {model_line!r}")
            prefill_ms = float(re.search(r"prefill \d+x\d+: (\d+)ms",
                                         model_line)[1])
            decode_ms = float(re.search(r"seqs in (\d+)ms",
                                        serve_lines[1])[1])
            check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen"] + 1),
                  f"serve_lm tokens {tuple(toks.shape)}")
            gc.collect()
            torch.cuda.empty_cache()
            with contextlib.redirect_stdout(io.StringIO()):
                want = serve.main(EXAMPLE_SERVE)
            check(torch.equal(toks, want), "serve_lm's greedy tokens differ "
                  "from launch.serve.main's with the same argv")
            gc.collect()
            torch.cuda.empty_cache()

            # ---- train_lm at full width: the card, the loss falls ---------
            torch.cuda.reset_peak_memory_stats()
            fops.flash_attention.launches = 0
            losses, text = run("train_lm", EXAMPLE_TRAIN)
            train_peak = torch.cuda.max_memory_allocated()
            check(re.search(r"^\[train\] arch=\S+ .* device=cuda", text,
                            re.M), f"train_lm's first line: "
                  f"{text.splitlines()[:1]}")
            check(len(losses) == EXAMPLE_TRAIN_STEPS
                  and all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0], f"train_lm losses {losses}")
            check(fops.flash_attention.launches == 0,
                  "train_lm launched flash attention")
            step_ms = [float(x) for x in re.findall(
                r"^\[train\] step=\s*\d+ .* dt=(\d+)ms", text, re.M)]
            gc.collect()
            torch.cuda.empty_cache()

            # ---- topology_collectives on the dry-run's record -------------
            records = sorted(str(p) for p in dry.glob("*train_4k__pod1.json"))
            check(len(records) == 1, f"dry-run records {records}")
            prices, text = run("topology_collectives", records)
        finally:
            if dryrun.poll() is None:
                dryrun.kill()
                dryrun.wait(5)
    priced = prices.get("qwen3_1_7b__train_4k__pod1", {})
    check(tuple(priced) == ICI_PRICED
          and all(math.isfinite(v) and v > 0 for v in priced.values()),
          f"topology_collectives priced {prices}")
    check(priced["folded_hexa_torus"] < priced["mesh"],
          f"folded_hexa_torus costs {priced['folded_hexa_torus']} s, mesh "
          f"{priced['mesh']} s")
    emit("examples", scripts=list(seconds), seconds_by_script=seconds,
         sim_equal_reference=True, sim_files=sorted(
             REFERENCE_EXAMPLES["files"]),
         netstep_launches=netstep_launches,
         netstep_launches_by_script=sim_launches,
         serve=dict(argv=EXAMPLE_SERVE, model_line=model_line,
                    flash_launches=flash, prefill_ms=prefill_ms,
                    decode_ms_per_token=decode_ms / SERVE["gen"],
                    tokens_equal_serve_main=True,
                    sample=toks[0, :8].tolist(),
                    peak_memory_gb=serve_peak / 1e9),
         train=dict(argv=EXAMPLE_TRAIN, losses=losses, step_ms=step_ms,
                    median_step_ms_after_first=statistics.median(
                        step_ms[1:]), peak_memory_gb=train_peak / 1e9),
         topology_collectives=dict(dryrun_argv=EXAMPLE_DRYRUN,
                                   dryrun_seconds=dry_s,
                                   dryrun_wait_seconds=dry_wait_s,
                                   step_collective_s=priced),
         nvidia_smi=smi, seconds=round(time.perf_counter() - t_phase, 3))
    return dict(netstep=netstep_launches, flash_attention=flash)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import costmodel
        from repro_torch.core import simulator as sim
        from repro_torch.core import topology as T
        from repro_torch.core import traffic as TR
        from repro_torch.core.routing import build_routing
        from repro_torch.kernels import ablate
        from repro_torch.kernels.build import build_all, nvcc
        from repro_torch.kernels.cycle import ops as cops
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.netstep import ops as nops
        from repro_torch.kernels.netstep.ops import netstep
        from repro_torch.obs.metrics import metrics
        from repro_torch.kernels.netstep.ref import netstep_ref
        from repro_torch.kernels.ssd_scan import ops as sops
        from repro_torch.launch import serve
        from repro_torch.sweep.engine import SweepEngine
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    # float32 products in full float32 wherever a phase compares in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- device ------------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = (nops.LIB, *fops.LIBS.values(), *sops.LIBS.values())
    floor_lib = ablate.variant_libs("netstep")["empty"]
    paths = build_all(libs + (floor_lib, cops.LIB))
    for lib in libs + (cops.LIB,):
        lib.launcher()
    build_s = time.perf_counter() - t0
    netstep_ptxas = ptxas_lines(paths[0])
    spills = spill_bytes(netstep_ptxas)
    emit("build", seconds=round(build_s, 3),
         library=str(paths[0].relative_to(ROOT)), ptxas=netstep_ptxas,
         spill_bytes=sum(spills), cycle_ptxas=ptxas_lines(paths[-1]))
    check(spills and not any(spills),
          f"netstep: ptxas reports spills or nothing: {netstep_ptxas}")
    # the hd 256 instantiations of both flash routes (template argument
    # 256: "ILi256E" in the mangled name), spills included
    hd256 = {lib.stem: {f: r for f, r in ptxas_functions(path).items()
                        if "ILi256E" in f}
             for lib, path in zip(libs, paths)
             if lib.stem.startswith("flash_attention")}
    emit("build_lm", seconds=round(build_s, 3), built_with="netstep",
         libraries={lib.stem: dict(library=str(path.relative_to(ROOT)),
                                   ptxas=ptxas_lines(path))
                    for lib, path in zip(libs[1:], paths[1:])},
         flash_hd256_ptxas=hd256)
    check(all(hd256.values()), f"no hd 256 flash instantiation in the "
          f"ptxas logs: {hd256}")

    # ---- SASS: the bf16 routes run on the tensor cores, netstep matches ----
    counts = {lib.stem: sass_counts(path, nvcc())
              for lib, path in zip(libs, paths)}
    emit("sass", counts=counts)
    check(counts["flash_attention_bf16"]["HGMMA"] > 0,
          "no HGMMA in the bf16 flash-attention kernel")
    check(counts["ssd_scan_bf16"]["HGMMA"] + counts["ssd_scan_bf16"]["HMMA"]
          > 0, "no HGMMA or HMMA in the bf16 SSD kernels")
    check(counts["netstep"]["MATCH"] > 0, "no MATCH in the netstep kernel")

    # ---- kernel vs plain ---------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    max_err, cases = 0, 0
    for shape in ((16, 5, 4), (100, 7, 4), (64, 31, 2)):
        op_slot, eligible = random_alloc_inputs(torch, gen, (1,) + shape,
                                                dev)
        for rr in (0, 3, 11):
            rr_t = torch.tensor([rr], dtype=torch.int32, device=dev)
            max_err = max(max_err, compare_kernel(
                torch, netstep, netstep_ref, op_slot, eligible, rr_t, rr_t))
            cases += 1
    for _ in range(24):
        b = int(torch.randint(1, 9, (1,), generator=gen))
        n = int(torch.randint(1, 80, (1,), generator=gen))
        pi = int(torch.randint(1, 33, (1,), generator=gen))
        v = int(torch.randint(1, 9, (1,), generator=gen))
        op_slot, eligible = random_alloc_inputs(torch, gen, (b, n, pi, v),
                                                dev)
        rr_vc = torch.randint(0, 1000, (b,), generator=gen,
                              dtype=torch.int32).to(dev)
        rr_port = torch.randint(0, 1000, (b,), generator=gen,
                                dtype=torch.int32).to(dev)
        max_err = max(max_err, compare_kernel(
            torch, netstep, netstep_ref, op_slot, eligible, rr_vc, rr_port))
        cases += 1
    # every warp layout and load width; slots one past [0, PI) on both
    # sides, and ineligible VCs that carry a slot
    for pi in LANE_PIS:
        for v in LANE_VS:
            shape = (3, LANE_N, pi, v)
            op_slot = torch.randint(-2, pi + 1, shape, generator=gen,
                                    dtype=torch.int32).to(dev)
            eligible = (torch.rand(shape, generator=gen) < 0.6).to(dev)
            rr_vc, rr_port = (torch.randint(
                -40, 1000, (3,), generator=gen, dtype=torch.int32).to(dev)
                for _ in range(2))
            max_err = max(max_err, compare_kernel(
                torch, netstep, netstep_ref, op_slot, eligible, rr_vc,
                rr_port))
            cases += 1
    for shape in ROW_SHAPES:
        op_slot, eligible = random_alloc_inputs(torch, gen, shape, dev)
        rr_vc, rr_port = (torch.randint(
            0, 1000, (shape[0],), generator=gen, dtype=torch.int32).to(dev)
            for _ in range(2))
        max_err = max(max_err, compare_kernel(
            torch, netstep, netstep_ref, op_slot, eligible, rr_vc, rr_port))
        cases += 1
    main_shape = ablate.NETSTEP_SHAPES[0]
    op_main, el_main = random_alloc_inputs(torch, gen, main_shape, dev)
    rr_vc_main = torch.arange(32, dtype=torch.int32, device=dev) % 4
    rr_port_main = torch.arange(32, dtype=torch.int32, device=dev) % 7
    max_err = max(max_err, compare_kernel(
        torch, netstep, netstep_ref, op_main, el_main, rr_vc_main,
        rr_port_main))
    cases += 1
    # a view at a storage offset breaks the int4 loads' alignment: raises
    flat = torch.empty(op_main.numel() + 1, dtype=torch.int32, device=dev)
    misaligned = flat[1:].view(main_shape)
    misaligned.copy_(op_main)
    try:
        netstep(misaligned, el_main, rr_vc_main, rr_port_main)
        raised = False
    except ValueError as e:
        raised = "aligned" in str(e)
    check(raised, "a misaligned op_slot did not raise")
    # an empty input gives empty outputs and launches nothing
    before = netstep.launches
    empty = netstep(op_main[:0], el_main[:0], rr_vc_main[:0],
                    rr_port_main[:0])
    torch.cuda.synchronize()
    check(netstep.launches == before and empty[0].shape == (0,) + main_shape[1:]
          and empty[1].shape == (0,) + main_shape[1:3],
          "an empty netstep input launched or gave the wrong shapes")
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
         lane_pis=LANE_PIS, lane_vs=LANE_VS, lane_n=LANE_N,
         misaligned_raises=True, empty_launches=0,
         seconds=round(time.perf_counter() - t0, 3))

    # ---- simulator: kernel vs plain vs CPU ---------------------------------
    t0 = time.perf_counter()
    specs = []
    for topo_name, n in HETERO:
        r = build_routing(T.build(topo_name, n))
        specs.append(sim.make_spec(r, TR.uniform(r.topo)))
    cfg = sim.SimConfig(cycles=300, warmup=100)
    before = netstep.launches
    on_kernel = sim.run_batch(specs, HETERO_RATES, cfg)
    kernel_launches = netstep.launches - before
    check(kernel_launches == cfg.cycles,
          f"alloc='auto' on the card launched {kernel_launches} kernels "
          f"for {cfg.cycles} cycles")
    on_plain = sim.run_batch(specs, HETERO_RATES, cfg._replace(alloc="torch"),
                             device="cuda")
    on_cpu = sim.run_batch(specs, HETERO_RATES, cfg, device="cpu")
    for (topo_name, n), k, p, c in zip(HETERO, on_kernel, on_plain, on_cpu):
        for key in RAW:
            check((k[key] == p[key]).all() and (k[key] == c[key]).all(),
                  f"{topo_name}{n} {key}: kernel {k[key].tolist()} plain "
                  f"{p[key].tolist()} cpu {c[key].tolist()}")
    emit("sim_kernel_vs_plain", specs=[f"{a}{b}" for a, b in HETERO],
         rates=HETERO_RATES, cycles=cfg.cycles, bitwise_equal=True,
         kernel_launches=kernel_launches,
         delivered={f"{a}{b}": k["delivered"].tolist()
                    for (a, b), k in zip(HETERO, on_kernel)},
         seconds=round(time.perf_counter() - t0, 3))

    # ---- main path -------------------------------------------------------------
    t0 = time.perf_counter()
    topos, specs, rates = [], [], []
    for topo_name in REFERENCE:
        r = build_routing(T.build(topo_name, MAIN_N, substrate="organic"))
        traffic = TR.uniform(r.topo)
        topos.append(r.topo)
        specs.append(sim.make_spec(r, traffic))
        rates.append(sim.saturation_rate_grid(r.saturation_rate(traffic), 8))
    setup_s = time.perf_counter() - t0
    cfg = sim.SimConfig()
    engine = SweepEngine(cfg=cfg)
    torch.cuda.synchronize()
    netstep.launches = 0
    cops.cycle_route.launches = cops.cycle_move.launches = 0
    fused_before = metrics.get("sim.fused_cycles")
    t1 = time.perf_counter()
    results = engine.run_specs(specs, rates)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    main_launches = netstep.launches
    groups = engine.stats["groups"]
    cycle_launches = dict(
        cycle_route=cops.cycle_route.launches,
        cycle_move=cops.cycle_move.launches,
        fused_cycles=metrics.get("sim.fused_cycles") - fused_before)
    check(main_launches == cfg.cycles * groups,
          f"main path launched netstep {main_launches} times for "
          f"{cfg.cycles} cycles x {groups} groups")
    check(all(n == cfg.cycles * groups for n in cycle_launches.values()),
          f"main path ran the fused cycle kernels {cycle_launches} for "
          f"{cfg.cycles} cycles x {groups} groups")
    rows = {}
    for topo, spec, res in zip(topos, specs, results):
        ref = REFERENCE[topo.name]
        for key in ("delivered", "lat_sum"):
            check(res[key].tolist() == ref[key],
                  f"{topo.name} {key} {res[key].tolist()} != reference "
                  f"{ref[key]}")
        i = int(res["throughput"].argmax())
        sat = float(res["throughput"][i])
        check(sat == ref["sim_saturation"],
              f"{topo.name} saturation {sat} != {ref['sim_saturation']}")
        rows[topo.name] = dict(
            sim_saturation=sat, latency_at_sat=float(res["latency"][i]),
            abs_throughput_tbps=costmodel.absolute_throughput_gbps(
                topo, sat) / 1e3,
            spec=dict(n=spec.n, p=spec.p, c=spec.c, d=spec.d))
    emit("main_path", topologies=rows, groups=groups,
         netstep_launches=main_launches, cycles=cfg.cycles,
         cycle_launches=cycle_launches,
         counters_equal_reference=True, setup_seconds=round(setup_s, 3),
         wall_seconds=wall_s, seconds_per_run=wall_s / len(specs),
         ms_per_simulated_cycle=1e3 * wall_s / (cfg.cycles * groups))

    # ---- timing at the allocator's shapes ------------------------------------
    # device time per launch beside the bound and the launch floor (the
    # same grid with the kernel's body cut out), and CUDA-event time of back-to-back wrapper calls, which the host bounds
    shape_rows = []
    kernel_lib = nops.LIB
    for shape in ablate.NETSTEP_SHAPES:
        if shape == main_shape:
            args = (op_main, el_main, rr_vc_main, rr_port_main)
        else:
            args = ablate.netstep_inputs(shape, gen, dev)
        outs = netstep(*args)
        torch.cuda.synchronize()
        call = lambda args=args: netstep(*args)
        kernel_ms = time_ms(torch, call, TIMING_SAMPLES, LAUNCHES_PER_SAMPLE)
        device_ms = wrapper_device_ms(torch, call,
                                      calls=NETSTEP_PROFILED_CALLS)[0]
        ablate.use_lib("netstep", floor_lib)
        floor_ms = wrapper_device_ms(torch, call,
                                     calls=NETSTEP_PROFILED_CALLS)[0]
        ablate.use_lib("netstep", kernel_lib)
        plain_ms = time_ms(torch, lambda args=args: netstep_ref(*args),
                           TIMING_SAMPLES, LAUNCHES_PER_SAMPLE)
        n_bytes = sum(t.numel() * t.element_size() for t in args + outs)
        bound_ms, bound_by, n_ops = netstep_bound(shape, n_bytes)
        shape_rows.append(dict(
            shape=list(shape), device_ms=device_ms, events_ms=kernel_ms,
            wrapper_host_us=1e3 * (kernel_ms - device_ms)
            if device_ms is not None else None,
            empty_kernel_floor_ms=floor_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, ops=n_ops,
            plain_ms=plain_ms))
    main_row = shape_rows[0]
    emit("timing", shapes=shape_rows, samples=TIMING_SAMPLES,
         launches_per_sample=LAUNCHES_PER_SAMPLE,
         profiled_calls=NETSTEP_PROFILED_CALLS, library_ms=None,
         library_note="no single PyTorch call computes this allocation",
         nvidia_smi=smi)

    # ---- profile: device busy/idle share of simulated cycles -------------------
    group = [specs[-1]] * 4                      # the main path's widest group
    group_rates = [rates[-1]] * 4
    prof_cfg = sim.SimConfig(cycles=PROFILE_CYCLES, warmup=0)
    sim.run_batch(group, group_rates, prof_cfg._replace(cycles=2))
    torch.cuda.synchronize()
    static_profile = dict(
        shape=[32, MAIN_N, group[0].p + 1, prof_cfg.n_vcs],
        **profile_cycles(torch, lambda: sim.run_batch(
            group, group_rates, prof_cfg), PROFILE_CYCLES))
    emit("profile", kernel_device_ms=main_row["device_ms"],
         sim_shape=static_profile["shape"], sim_cycles=PROFILE_CYCLES,
         sim_wall_s=static_profile["wall_s"],
         sim_device_busy_s=static_profile["device_busy_s"],
         device_idle_share=static_profile["device_idle_share"],
         device_launches_per_cycle=static_profile[
             "device_launches_per_cycle"],
         top_device_us_per_cycle=static_profile.pop("top_device_us"))
    cycle_rows = cycle_kernels_phase(torch, group, group_rates,
                                     [topos[-1]] * 4, cycle_launches)

    workload_phase(torch, dev, netstep)
    exp_launches = experiments_phase(torch, dev, smi, netstep,
                                     static_profile)
    coll_launches = collectives_phase(torch, dev, smi, netstep)
    adaptive_kernel_phase(torch, dev, netstep)
    adaptive_launches = adaptive_phase(torch, dev, smi, netstep,
                                       static_profile)
    synth_launches = synth_phase(torch, dev, smi, netstep, static_profile)
    analysis_launches = analysis_phase(torch, dev, smi, netstep)

    lm_rows = lm_phases(torch, dev, smi, fops, sops, serve)
    full_losses = train_phase(torch, dev, smi, fops, sops)
    fam_launches = families_phase(torch, dev, smi, fops, sops, serve)
    for row, i in zip(lm_rows, (0, 1)):
        row["launches_families"] = {a: c[i] for a, c in fam_launches.items()}
    lm_rows[0]["launches_sharded"] = {
        SHARDED["arch"]: sharded_phase(torch, dev, smi, fops, serve)}
    train_launches = sharded_train_phase(torch, dev, smi, fops, sops,
                                         full_losses)
    for row, n in zip(lm_rows, train_launches):
        row["launches_sharded_train"] = {TRAIN_ARCH: n}
    example_launches = examples_phase(torch, smi, netstep, fops, sops)
    lm_rows[0]["launches_examples"] = example_launches["flash_attention"]

    print(json.dumps({"kernels": [dict(
        name="netstep", route="cuda",
        source="src/repro_torch/kernels/netstep/csrc/netstep.cu",
        replaces="src/repro/kernels/netstep/netstep.py:28",
        launches=main_launches, launches_experiments=exp_launches,
        launches_collectives=coll_launches,
        launches_adaptive_telemetry=adaptive_launches,
        launches_synth=synth_launches, launches_analysis=analysis_launches,
        launches_examples=example_launches["netstep"],
        max_abs_err=max_err,
        ms=first(main_row["device_ms"], main_row["events_ms"]),
        events_ms=main_row["events_ms"],
        empty_kernel_floor_ms=main_row["empty_kernel_floor_ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=None)] + cycle_rows
        + lm_rows}),
        flush=True)
    emit("done", seconds=round(time.perf_counter() - t_all, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
