#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card
and hold it against its references.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  Phases, each printing one JSON line:

  device               card name and power limit (nvidia-smi), versions
  build                nvcc builds the netstep kernel from the checkout
  kernel_vs_plain      the CUDA netstep equals its plain PyTorch version
                       on the card, bit for bit, plus the allocation
                       invariants
  sim_kernel_vs_plain  the simulator's counters with the kernel, with
                       the plain allocator on the card, and on the CPU
                       are equal (the CPU path is held against the JAX
                       package by the CPU tests)
  main_path            mesh, hexamesh and folded_hexa_torus at N = 256
                       (organic, uniform, default SimConfig) through
                       SweepEngine.run_specs; counters equal the JAX
                       reference's, and every cycle went through the
                       kernel
  timing               CUDA-event times of the kernel and of the plain
                       version at the main path's shape, beside the
                       kernel's bound
  profile              torch.profiler: the kernel's device time, and the
                       device busy/idle share of simulated cycles at the
                       main path's widest group

then the kernel summary line and, last, the `{"ok": true, ...}` line.
A failed check raises and exits non-zero before the last line; without
a card, or without the repository beside this script, it exits
non-zero and prints no result.
"""
import json
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
        from repro_torch.kernels.netstep import build as kbuild
        from repro_torch.kernels.netstep.ops import netstep
        from repro_torch.kernels.netstep.ref import netstep_ref
        from repro_torch.sweep.engine import SweepEngine
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
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
    lib_path = kbuild.build()
    kbuild.load()
    build_s = time.perf_counter() - t0
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(build_s, 3),
         library=str(lib_path.relative_to(ROOT)), ptxas=ptxas)

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
    main_shape = (32, MAIN_N, 7, 4)
    op_main, el_main = random_alloc_inputs(torch, gen, main_shape, dev)
    rr_vc_main = torch.arange(32, dtype=torch.int32, device=dev) % 4
    rr_port_main = torch.arange(32, dtype=torch.int32, device=dev) % 7
    max_err = max(max_err, compare_kernel(
        torch, netstep, netstep_ref, op_main, el_main, rr_vc_main,
        rr_port_main))
    cases += 1
    emit("kernel_vs_plain", cases=cases, max_abs_err=max_err,
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

    # ---- timing at the main path's shape -----------------------------------
    args = (op_main, el_main, rr_vc_main, rr_port_main)
    outs = netstep(*args)
    torch.cuda.synchronize()
    kernel_ms = time_ms(torch, lambda: netstep(*args), TIMING_SAMPLES,
                        LAUNCHES_PER_SAMPLE)
    plain_ms = time_ms(torch, lambda: netstep_ref(*args), TIMING_SAMPLES,
                       LAUNCHES_PER_SAMPLE)
    n_bytes = sum(t.numel() * t.element_size() for t in args + outs)
    # per input port: V compare-selects of phase a, PI shuffled
    # compares of phase b, V stores (a lower bound on the operations)
    b_, n_, pi_, v_ = main_shape
    n_ops = b_ * n_ * pi_ * (3 * v_ + 3 * pi_)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    emit("timing", shape=list(main_shape), kernel_ms=kernel_ms,
         plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
         bytes=n_bytes, ops=n_ops, samples=TIMING_SAMPLES,
         launches_per_sample=LAUNCHES_PER_SAMPLE, library_ms=None,
         library_note="no single PyTorch call computes this allocation",
         nvidia_smi=smi)

    # ---- profile: device time of the kernel and of a simulated cycle ---
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(LAUNCHES_PER_SAMPLE):
            netstep(*args)
        torch.cuda.synchronize()
    kern = [e for e in device_rows(prof) if "netstep_kernel" in e.key]
    kernel_device_ms = (device_us(kern[0]) / kern[0].count / 1e3
                        if kern and device_us(kern[0]) > 0 else None)
    group = [specs[-1]] * 4                      # the main path's widest group
    group_rates = [rates[-1]] * 4
    prof_cfg = sim.SimConfig(cycles=PROFILE_CYCLES, warmup=0)
    sim.run_batch(group, group_rates, prof_cfg._replace(cycles=2))
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run_batch(group, group_rates, prof_cfg)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    events = device_rows(prof)
    busy_s = sum(device_us(e) for e in events) / 1e6
    top = sorted(events, key=device_us, reverse=True)[:8]
    emit("profile", kernel_device_ms=kernel_device_ms,
         sim_shape=[32, MAIN_N, group[0].p + 1, prof_cfg.n_vcs],
         sim_cycles=PROFILE_CYCLES, sim_wall_s=prof_wall_s,
         sim_device_busy_s=busy_s if busy_s > 0 else None,
         device_idle_share=(1 - busy_s / prof_wall_s) if busy_s > 0
         else None,
         device_launches_per_cycle=sum(e.count for e in events)
         / PROFILE_CYCLES if busy_s > 0 else None,
         top_device_us_per_cycle={
             e.key[:60]: device_us(e) / PROFILE_CYCLES for e in top})

    print(json.dumps({"kernels": [dict(
        name="netstep", route="cuda",
        source="src/repro_torch/kernels/netstep/csrc/netstep.cu",
        replaces="src/repro/kernels/netstep/netstep.py:28",
        launches=main_launches, max_abs_err=max_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None)]}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_all, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
