"""Compute the JAX reference tables of `chip_smoke.py`'s `experiments`,
`collectives`, `adaptive_telemetry`, `synth`, `analysis`, `train`,
`families_parity` and `examples` phases.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/smoke_reference.py \
        [experiments|collectives|adaptive|synth|analysis|train|families|
         examples]

`experiments` builds that phase's Experiment
(`chip_smoke.experiment_scenarios`: 15 scenarios at N = 256, organic,
`SaturationGrid(8)`) with the JAX package's classes; `collectives` builds
`chip_smoke.collective_scenarios` (20 scenarios at N = 64: the training
collectives of qwen3-1.7b and qwen3-moe-235b-a22b and a mixed tenant)
and also evaluates `repro.core.collectives.build_ici_model(..., 64,
"organic", use_sim=True)` on chip_smoke's `ICI_TOPOLOGIES`.  Each
Experiment runs through `repro.experiments.run` under
`SimConfig(cycles=2000, warmup=700, alloc="jnp")`.  Prints one JSON
object per table: per scenario, in order, the label, the raw counters
over the rate grid and the tidy row's values at the saturating rate.
`chip_smoke.py` holds the port's runs of the same Experiments on the
card to these tables (its `REFERENCE_EXPERIMENTS` and
`REFERENCE_COLLECTIVES`), bit for bit.  `adaptive` builds
`chip_smoke.adaptive_scenarios` (6 scenarios at N = 256: mesh, torus and
folded_hexa_torus under hotspot_drift, static and adaptive) under
`chip_smoke.adaptive_cfg` (the flight recorder on, 6 windows) and prints
`chip_smoke.adaptive_table` of the frame (`REFERENCE_ADAPTIVE`).  `synth`
runs `repro.synth.run_search(SearchConfig(n=48, substrate="organic",
seed=0))` and prints `chip_smoke.synth_table` of the result
(`REFERENCE_SYNTH`, about 30 s); `analysis` runs `python -m
repro.analysis --all-builtin --jax` (in this process) and
`repro.analysis.analyze(names=["folded_hexa_torus"], n=36, fault_kmax=2)`
and prints `chip_smoke.analysis_table` of them (`REFERENCE_ANALYSIS`,
seconds).  `train` runs `repro.launch.steps.make_train_step` on
chip_smoke's `TRAIN_ARCH` smoke config at float32 compute, from the
parameters `chip_smoke.train_smoke_params` draws, over `TRAIN_SMOKE`'s
steps of `SyntheticLMData`, with the train driver's schedule, once
whole and once with microbatches=2, and prints each step's loss and grad
norm (`REFERENCE_TRAIN`, seconds).  `families` runs the smoke configs of
`chip_smoke.FAMILY_ARCHS` (MLA, the encoder-decoder, MoE with and
without virtual-split experts, the attention:SSM:MoE hybrid) at float32
compute from `train_smoke_params`: prefill and two decode steps on
`chip_smoke.family_inputs`, and the first train step's loss and grad
norm (`REFERENCE_FAMILIES`, seconds).  `examples` runs the six
simulator scripts of `examples/` (`chip_smoke.SIM_EXAMPLES`), unedited,
each in its own process, all at once, from a copy of the directory in a
temporary one whose sibling `results/` takes what they write, and
prints the SHA-256 of each file they write and each one's printed
result lines (`chip_smoke.example_lines`): `REFERENCE_EXAMPLES`, about
a minute.  Without an argument, all eight tables; the first three take
several minutes each on an 8-core CPU.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402  (stdlib only at import)
import repro.configs as C  # noqa: E402
import repro.experiments as X  # noqa: E402
import repro.faults as F  # noqa: E402
import repro.workloads as W  # noqa: E402
from repro.core import topology as T  # noqa: E402
from repro.core.collectives import build_ici_model  # noqa: E402
from repro.core.simulator import SimConfig  # noqa: E402

RAW = ("delivered", "offered_n", "accepted_n", "lat_sum")


def table(frame, raw=("delivered", "lat_sum"), substrate=False) -> list:
    """The reference entries of a frame, in scenario order."""
    rows = []
    for row, res in zip(frame.rows, frame.results):
        k = int(np.argmax(res["throughput"]))
        parts = [row["topology"]] + ([row["substrate"]] if substrate
                                     else []) + [row["traffic"],
                                                 row["faults"]]
        ent = dict(label="/".join(parts))
        ent.update({key: res[key].tolist() for key in raw})
        ent.update(sim_saturation=row["sim_saturation"],
                   abs_throughput_gbps=row["abs_throughput_gbps"],
                   latency_ns=row["latency_ns"])
        if "delivered_ph" in res:
            ent["delivered_ph"] = res["delivered_ph"][k].tolist()
        rows.append(ent)
    return rows


def run(scenarios, name, cfg=None):
    t0 = time.perf_counter()
    cfg = cfg or SimConfig(cycles=chip_smoke.EXP_CYCLES,
                           warmup=chip_smoke.EXP_WARMUP, alloc="jnp")
    frame = X.run(X.Experiment(scenarios, cfg=cfg, name=name,
                               backend="sim"), on_error="raise",
                  progress=lambda done, total, key: print(
                      f"{name} {done}/{total} {key} "
                      f"{time.perf_counter() - t0:.0f}s",
                      file=sys.stderr, flush=True))
    assert all(r["status"] == "ok" for r in frame.rows)
    return frame


def adaptive(n=chip_smoke.MAIN_N, cycles=chip_smoke.EXP_CYCLES,
             warmup=chip_smoke.EXP_WARMUP, n_rates=chip_smoke.EXP_RATES,
             windows=chip_smoke.ADAPTIVE_WINDOWS) -> dict:
    """`chip_smoke.adaptive_table` of the adaptive_telemetry Experiment
    run by the JAX package (the arguments cut it down for tests)."""
    cfg = chip_smoke.adaptive_cfg(SimConfig, cycles, warmup,
                                  windows)._replace(alloc="jnp")
    frame = run(chip_smoke.adaptive_scenarios(X, W, n, n_rates),
                "chip_smoke_adaptive", cfg)
    return chip_smoke.adaptive_table(frame)


def synth(n=chip_smoke.SYNTH_N) -> dict:
    """`chip_smoke.synth_table` of the JAX package's search (`n` cuts it
    down for tests)."""
    import repro.synth as S
    from repro.experiments import io
    res = S.run_search(S.SearchConfig(n=n, substrate="organic", seed=0))
    return chip_smoke.synth_table(res, X, io)


def analysis() -> dict:
    """`chip_smoke.analysis_table` of the JAX package's analyzer."""
    import contextlib
    import io
    import tempfile

    import repro.analysis as A
    from repro.analysis.__main__ import main as cli
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "diagnostics.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["--all-builtin", "--jax", "-q", "-o", path])
        with open(path) as f:
            doc = json.load(f)
    rep = A.analyze(names=["folded_hexa_torus"], n=36, fault_kmax=2)
    return chip_smoke.analysis_table(doc, rc, rep)


def port_names(cfg, path, leaf):
    """The port's parameter names of a JAX parameter leaf, and the leaf's
    shape in the port: blocks are stacked over the pattern's repetitions
    here (`layers.{rep * len(pattern) + slot}`), an encoder-decoder's
    `enc_blocks` over its encoder layers (`enc_layers.{i}`)."""
    pat, n_rep, _ = cfg.pattern()
    keys = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
    if keys[0] == "blocks":
        rest = ".".join(keys[2:])
        return ([f"layers.{r * len(pat) + int(keys[1])}.{rest}"
                 for r in range(n_rep)], leaf.shape[1:])
    if keys[0] == "tail":
        return ([f"layers.{n_rep * len(pat) + int(keys[1])}."
                 + ".".join(keys[2:])], leaf.shape)
    if keys[0] == "enc_blocks":
        rest = ".".join(keys[1:])
        return ([f"enc_layers.{i}.{rest}" for i in range(leaf.shape[0])],
                leaf.shape[1:])
    return [".".join(keys)], leaf.shape


def smoke_params(model, seed: int):
    """The JAX parameters of `model` that `chip_smoke.train_smoke_params`
    draws by the port's names."""
    import jax
    import jax.numpy as jnp
    from repro.models import unbox

    shapes, _ = unbox(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    named = [(name, shape) for path, leaf in leaves
             for names, shape in [port_names(model.cfg, path, leaf)]
             for name in names]
    flat = chip_smoke.train_smoke_params(named, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(np.stack(
            [flat[n] for n in port_names(model.cfg, path, leaf)[0]]).reshape(
                leaf.shape)), shapes)


def train() -> dict:
    """The JAX package's losses and grad norms of chip_smoke's training
    parity run (`chip_smoke.TRAIN_SMOKE`)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticLMData
    from repro.launch import steps as St
    from repro.models import Model
    from repro.optim import AdamWConfig, adamw_init

    ts = chip_smoke.TRAIN_SMOKE
    cfg = dataclasses.replace(C.get_config(chip_smoke.TRAIN_ARCH, smoke=True),
                              compute_dtype=jnp.float32)
    model = Model(cfg)
    params = smoke_params(model, ts["seed"])
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=ts["seq"],
                           global_batch=ts["batch"], seed=ts["seed"])
    out = {}
    for k, suffix in ((1, ""), (2, "_mb2")):
        tcfg = St.TrainConfig(opt=AdamWConfig(), microbatches=k,
                              total_steps=ts["steps"],
                              warmup_steps=max(ts["steps"] // 20, 5))
        step = jax.jit(St.make_train_step(model, tcfg))
        p, opt = params, adamw_init(params)
        losses, norms = [], []
        for i in range(ts["steps"]):
            p, opt, met = step(p, opt, {key: jnp.asarray(v) for key, v
                                        in data.batch(i).items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out["loss" + suffix], out["grad_norm" + suffix] = losses, norms
    return out


def families() -> dict:
    """The JAX package's numbers of chip_smoke's `families_parity`: for
    each of `chip_smoke.FAMILY_ARCHS` at float32 compute, from the
    parameters `train_smoke_params` draws, the prefill logits and two
    decode steps' logits (`chip_smoke.logits_summary`) on
    `chip_smoke.family_inputs`, and the loss and grad norm of the train
    driver's first step on `SyntheticLMData` (and, for the
    encoder-decoder, the driver's frames of step 0)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.data import SyntheticLMData
    from repro.launch import steps as St
    from repro.models import Model
    from repro.optim import AdamWConfig, adamw_init

    fs = chip_smoke.FAMILIES_SMOKE
    out = {}
    for arch in chip_smoke.FAMILY_ARCHS:
        cfg = dataclasses.replace(C.get_config(arch, smoke=True),
                                  compute_dtype=jnp.float32)
        model = Model(cfg)
        params = smoke_params(model, fs["seed"])
        toks, frames, steps = chip_smoke.family_inputs(cfg)
        batch = {"tokens": jnp.asarray(toks, jnp.int32)}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        logits, caches = jax.jit(model.prefill)(params, batch)
        rows = [chip_smoke.logits_summary(np.asarray(logits))]
        decode = jax.jit(model.decode_step)
        for i in range(fs["decode"]):
            logits, caches = decode(params, caches,
                                    jnp.asarray(steps[i], jnp.int32),
                                    jnp.int32(fs["prompt"] + i))
            rows.append(chip_smoke.logits_summary(np.asarray(logits[:, -1])))
        b, t = fs["train_batch"], fs["train_seq"]
        tb = {k: jnp.asarray(v) for k, v in SyntheticLMData(
            vocab=cfg.vocab, seq_len=t, global_batch=b,
            seed=fs["seed"]).batch(0).items()}
        if cfg.arch_kind == "encdec":
            tb["frames"] = jnp.asarray(np.random.default_rng(0).normal(
                0, 0.02, (b, t, cfg.d_model)), jnp.float32)
        step = jax.jit(St.make_train_step(model, St.TrainConfig(
            opt=AdamWConfig(), total_steps=1, warmup_steps=5)))
        _, _, met = step(params, adamw_init(params), tb)
        out[arch] = dict(prefill=rows[0], decode=rows[1:],
                         loss=float(met["loss"]),
                         grad_norm=float(met["grad_norm"]))
    return out


ROOT = Path(__file__).resolve().parents[1]
# one thread per example process: they run side by side
ONE_THREAD = dict(OMP_NUM_THREADS="1", XLA_FLAGS=(
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))
EXAMPLES_DEADLINE_S = 600


def start_examples(workdir, scripts, port_args=None) -> dict:
    """Start the reference example `examples/<script>.py` of each of
    `scripts`, unedited, from a copy of `examples/` in `workdir`, so that
    it writes to `workdir/results/` (JAX on the CPU); and, given
    `port_args`, the port's `examples_torch/<script>.py` with them and
    `--out workdir/port`.  All at once, one thread each, from `workdir`.
    Returns {(script, "reference" | "port"): Popen}."""
    workdir = Path(workdir)
    if not (workdir / "examples").exists():
        shutil.copytree(ROOT / "examples", workdir / "examples")
        (workdir / "results").mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **ONE_THREAD)
    runs = {(s, "reference"): [str(workdir / "examples" / f"{s}.py")]
            for s in scripts}
    if port_args is not None:
        runs.update({(s, "port"): [
            str(ROOT / "examples_torch" / f"{s}.py"), *port_args, "--out",
            str(workdir / "port")] for s in scripts})
    return {key: subprocess.Popen([sys.executable, *cmd], cwd=workdir,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
            for key, cmd in runs.items()}


def finish_examples(procs: dict, deadline_s: float = EXAMPLES_DEADLINE_S
                    ) -> dict:
    """{key: stdout} of `start_examples`' processes; raises, with every
    process stopped, if one exits non-zero or they are not done within
    `deadline_s`."""
    end = time.monotonic() + deadline_s
    outs = {}
    try:
        for key, p in procs.items():
            out, err = p.communicate(timeout=max(end - time.monotonic(), 1))
            if p.returncode:
                raise RuntimeError(f"{key} exited {p.returncode}: "
                                   f"{err[-3000:]}")
            outs[key] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(5)
    return outs


def example_runs(workdir, scripts, port_args=None) -> dict:
    """Each of `scripts` run by the reference and, given `port_args`, by
    the port, all at once (`start_examples`): {script: {"reference" |
    "port": dict(lines=`chip_smoke.example_lines`, raw=its stdout,
    out=the directory it writes to, files={name: bytes})}}."""
    workdir = Path(workdir)
    runs = {}
    for (s, side), raw in finish_examples(
            start_examples(workdir, scripts, port_args)).items():
        out = workdir / ("port" if side == "port" else "results")
        runs.setdefault(s, {})[side] = dict(
            lines=chip_smoke.example_lines(raw, out if side == "port"
                                           else None),
            raw=raw, out=str(out),
            files={name: (out / name).read_bytes()
                   for name in chip_smoke.SIM_EXAMPLES[s]})
    return runs


def examples() -> dict:
    """`REFERENCE_EXAMPLES`: the digests of the files the reference's
    simulator examples write and their printed result lines."""
    with tempfile.TemporaryDirectory() as d:
        runs = example_runs(d, chip_smoke.SIM_EXAMPLES)
    return dict(files={name: hashlib.sha256(data).hexdigest()
                       for r in runs.values()
                       for name, data in r["reference"]["files"].items()},
                lines={s: r["reference"]["lines"] for s, r in runs.items()})


def main(argv=None) -> int:
    which = (argv or sys.argv[1:]) or ["experiments", "collectives",
                                       "adaptive", "synth", "analysis",
                                       "train", "families", "examples"]
    if "experiments" in which:
        t0 = time.perf_counter()
        frame = run(chip_smoke.experiment_scenarios(X, W, F, T),
                    "chip_smoke")
        print(json.dumps(dict(table=table(frame),
                              seconds=time.perf_counter() - t0)),
              flush=True)
    if "collectives" in which:
        t0 = time.perf_counter()
        frame = run(chip_smoke.collective_scenarios(X, W, C),
                    "chip_smoke_collectives")
        ici = {}
        for name in chip_smoke.ICI_TOPOLOGIES:
            m = build_ici_model(name, chip_smoke.COLL_N, "organic",
                                use_sim=True)
            ici[name] = dict(b_eff_gbps=m.b_eff_gbps,
                             all_reduce_s=m.collective_time_s(
                                 "all_reduce", chip_smoke.ICI_BYTES))
        print(json.dumps(dict(table=table(frame, RAW, substrate=True),
                              ici=ici, seconds=time.perf_counter() - t0)),
              flush=True)
    for name, fn in (("adaptive", adaptive), ("synth", synth),
                     ("analysis", analysis), ("train", train),
                     ("families", families), ("examples", examples)):
        if name in which:
            t0 = time.perf_counter()
            out = fn()
            print(json.dumps(dict(out, seconds=time.perf_counter() - t0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
