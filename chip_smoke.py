#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card
and hold it against its references.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  Phases, each printing one JSON line:

  device               card name and power limit (nvidia-smi), versions
  build                nvcc builds the five kernel sources from the
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
                       kernel
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
  flash_vs_plain       the flash-attention kernels against their plain
                       version on the card: every case of
                       tests/test_torch_cuda.py (five (tq, tk, causal,
                       window) x hd 16/32/64/128/256, GQA 4:2) through both
                       routes, f32 (2e-5) and bf16 (2e-2), and qwen3-1.7b's
                       prefill shape [4, 1024, 16 (8 kv), 128] causal
                       through both; at hd 256, GQA 4:1, causal with
                       window None / 1024 / 96 at T 2048 and on ragged
                       128 / 256 pairs, and gemma3-1b's prefill shape
                       [4, 2048, 4 (1 kv), 256] global and local
  ssd_vs_plain         the SSD-scan kernels against their plain version:
                       the shapes of tests/test_torch_cuda.py through both
                       routes, f32 (1e-4) and bf16 (3e-2), the bf16
                       route's any-chunk shapes, and mamba2-1.3b's prefill
                       shape (B 4, T 1024, H 64, P 64, N 128, chunk 256):
                       bf16 at 3e-2, f32 no further from the f64
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
  lm_profile           torch.profiler: the device time of every CUDA kernel
                       one wrapper call launches, summed, per route (the
                       bf16 SSD call launches four), and the device idle
                       share of each arch's decode loop; and each call's
                       device ms from the replay of a CUDA graph of 20
                       back-to-back calls (kernels.ablate.graph_ms: no host
                       work between launches, no profiler misses), the
                       kernels line's `ms` for flash attention and SSD

then the kernel summary line and, last, the `{"ok": true, ...}` line.
A failed check raises and exits non-zero before the last line; without
a card, or without the repository beside this script, it exits
non-zero and prints no result.
"""
import copy
import dataclasses
import json
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
# netstep's warp layouts (R = 32 // PI routers per warp) and load widths
# (V in {1, 2, 4, 8} vector loads, V = 3 the generic kernel), held against
# the plain version on rows of LANE_N routers, no multiple of any R > 1
LANE_PIS = (1, 2, 5, 7, 8, 15, 16, 17, 31, 32)
LANE_VS = (1, 2, 3, 4, 8)
LANE_N = 13
# one router per row (the row is the router) and long rows (the row by a
# multiply-high), each row its own rr pair
ROW_SHAPES = ((40, 1, 7, 4), (9, 1, 2, 3), (7, 1000, 5, 4), (3, 4099, 31, 2))
NETSTEP_PROFILED_CALLS = 50

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


def profile_cycles(torch, run, cycles: int, sessions: int = 3) -> dict:
    """torch.profiler over `run()` (simulating `cycles` cycles): wall s,
    device busy s, device launches per cycle, idle share, and the eight
    costliest device ops' us per cycle.  The profiler on the card
    sometimes records no device event in a session, so a session that
    saw none is repeated, up to `sessions` times; None if none did."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    from repro_torch.sweep.engine import SweepEngine
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
    while len(items) % engine.s_round:
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
    from torch.profiler import ProfilerActivity, profile
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
    flash_err = max(path_errs["bfloat16"],
                    *(e for w, e in gemma_errs.items()
                      if w.startswith("bfloat16")))
    emit("flash_vs_plain", cases=errs, path_shape=list(fq.shape),
         path_kv_heads=fp["kv"], path_max_abs_err=path_errs,
         gemma3_shape=list(gemma_flash["bfloat16"][0].shape),
         gemma3_kv_heads=gp["kv"], gemma3_max_abs_err=gemma_errs,
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
    sp = SSD_PATH
    path_errs = {}
    for dname, dtype in dtypes.items():
        args = ssd_inputs(torch, gen, sp["b"], sp["t"], sp["h"], sp["p"],
                          sp["n"], dtype, dev)
        y, st = sops.ssd_scan(*args, chunk=sp["chunk"])
        yr, sr = sops.ssd_ref(*args, sp["chunk"])
        if dname == "bfloat16":
            ssd_args = args
            path_errs[dname] = dict(
                y=check_close(torch, y, yr, SSD_TOL[dname],
                              f"ssd {dname} y at the path shape"),
                state=check_close(torch, st, sr, SSD_TOL[dname],
                                  f"ssd {dname} state at the path shape"))
            continue
        # f32 at the path shape: sums of 256 terms in two orders differ by
        # more than 1e-4 here (the plain version is that far from its own
        # f64 evaluation), so the kernel is held against the f64
        # evaluation: no further from it than the plain f32 version is,
        # give or take F32_MARGIN
        f32_ssd = args
        y64, s64 = sops.ssd_ref(*(v.double() for v in args), sp["chunk"])
        errs64 = {}
        for what, got, plain, exact in (("y", y, yr, y64),
                                        ("state", st, sr, s64)):
            check(bool(torch.isfinite(got).all()), f"ssd f32 {what} finite")
            k, pl = max_err(got, exact), max_err(plain, exact)
            check(k <= F32_MARGIN * pl, f"ssd f32 {what} at the path shape "
                  f"is {k} from its f64 evaluation, the plain version {pl}")
            errs64[what] = dict(kernel_vs_plain=max_err(got, plain),
                                kernel_vs_f64=k, plain_vs_f64=pl)
        path_errs[dname] = errs64
        del y64, s64
    ssd_err = path_errs["bfloat16"]["y"]
    emit("ssd_vs_plain", cases=errs, path_shape=dict(sp),
         path_max_abs_err=path_errs, tol=SSD_TOL,
         seconds=round(time.perf_counter() - t0, 3))
    del y, st, yr, sr

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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for i in range(DECODE_PROFILE_STEPS):
                _, caches = model.decode_step(caches, tok, prompt + i)
            torch.cuda.synchronize()
            decode_wall_s = time.perf_counter() - t1
        events = device_rows(prof)
        busy_s = sum(device_us(e) for e in events) / 1e6
        serve_rows[arch] = dict(
            launches=counts, accuracy=accuracy, f32_tol=CARD_VS_CPU["tol"],
            prefill_ms=1e3 * stats["prefill_s"],
            decode_ms_per_token=1e3 * stats["decode_s"] / SERVE["gen"],
            tokens_per_s=SERVE["batch"] * SERVE["gen"] / stats["decode_s"],
            peak_memory_gb=peak / 1e9, sample=toks[0, :8].tolist(),
            decode_profile=dict(
                steps=DECODE_PROFILE_STEPS, wall_s=decode_wall_s,
                device_busy_s=busy_s if busy_s > 0 else None,
                device_idle_share=(1 - busy_s / decode_wall_s)
                if busy_s > 0 else None,
                device_launches_per_token=sum(e.count for e in events)
                / DECODE_PROFILE_STEPS if busy_s > 0 else None,
                top_device_us_per_token={
                    e.key[:60]: device_us(e) / DECODE_PROFILE_STEPS
                    for e in sorted(events, key=device_us,
                                    reverse=True)[:6]}))
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
             routes={"bfloat16": "cuda, mma.sync bf16 + TF32, four kernels: "
                                 "ssd_scan_bf16.cu",
                     "float32": "cuda, CUDA-core FMA: ssd_scan.cu"})]


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
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.netstep import ops as nops
        from repro_torch.kernels.netstep.ops import netstep
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
    paths = build_all(libs + (floor_lib,))
    for lib in libs:
        lib.launcher()
    build_s = time.perf_counter() - t0
    netstep_ptxas = ptxas_lines(paths[0])
    spills = spill_bytes(netstep_ptxas)
    emit("build", seconds=round(build_s, 3),
         library=str(paths[0].relative_to(ROOT)), ptxas=netstep_ptxas,
         spill_bytes=sum(spills))
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
    t1 = time.perf_counter()
    results = engine.run_specs(specs, rates)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    main_launches = netstep.launches
    groups = engine.stats["groups"]
    check(main_launches == cfg.cycles * groups,
          f"main path launched netstep {main_launches} times for "
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

    workload_phase(torch, dev, netstep)
    exp_launches = experiments_phase(torch, dev, smi, netstep,
                                     static_profile)
    coll_launches = collectives_phase(torch, dev, smi, netstep)

    lm_rows = lm_phases(torch, dev, smi, fops, sops, serve)

    print(json.dumps({"kernels": [dict(
        name="netstep", route="cuda",
        source="src/repro_torch/kernels/netstep/csrc/netstep.cu",
        replaces="src/repro/kernels/netstep/netstep.py:28",
        launches=main_launches, launches_experiments=exp_launches,
        launches_collectives=coll_launches,
        max_abs_err=max_err,
        ms=first(main_row["device_ms"], main_row["events_ms"]),
        events_ms=main_row["events_ms"],
        empty_kernel_floor_ms=main_row["empty_kernel_floor_ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=None)] + lm_rows}),
        flush=True)
    emit("done", seconds=round(time.perf_counter() - t_all, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
