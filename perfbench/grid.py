"""A cell's scenario grid, as plain data both sides are handed.

A configuration file (`perfbench/configs/<config>.json`) fixes the
deployment: sizes, topologies, substrate, chiplet areas, the simulator's
settings and, for collective traffic, the model whose training step
sizes it.  A traffic file (`perfbench/traffic/<mix>.json`) fixes the
traffic, the routing mode, the flight recorder and the grouping.

`scenario_defs` expands the two into `ScenarioDef`s in a fixed order:
size, then area, then traffic, then topology.  The program's scenarios
(`drivers/sim.py`) and the reference's (`reference/scenario.py`) are
both built from these definitions and nothing else.

Traffic kinds (the `kind` of each entry of the mix's `traffic` list):

  pattern       {"name": P}: a static pattern of the simulator
                (uniform, tornado, neighbor, permutation, ...)
  synthetic     {"name": F, "args": {...}}: a synthetic schedule
                (hotspot_drift, phase_alternating, bursty_uniform)
  collective    {"model": {...}?}: one sharded training step of the
                configuration's model (or of the entry's own)
  mixed_tenant  {"serve_pattern": P, "serve_frac": f, "model": {...}?}:
                that step beside a serving tenant
  trace_region  {"profile": name, "region": k}: a region of the
                synthetic Netrace-like traces
"""
from __future__ import annotations

import dataclasses
import json
import types
from pathlib import Path

from .reference import derivations

KINDS = ("pattern", "synthetic", "collective", "mixed_tenant",
         "trace_region")


@dataclasses.dataclass(frozen=True)
class ScenarioDef:
    """One scenario of a cell: everything either side needs to build it.
    `traffic` is the mix's entry, with `model` and `step` filled in for
    collective kinds; `traffic_json` is its canonical text."""
    index: int
    topology: str
    n: int
    substrate: str
    area: float
    roles: str
    traffic_json: str
    routing: str

    @property
    def traffic(self) -> dict:
        return json.loads(self.traffic_json)

    @property
    def label(self) -> str:
        t = self.traffic
        what = t.get("name") or t.get("profile") or t["kind"]
        return (f"{self.topology}/n{self.n}/{self.substrate}/"
                f"a{self.area:g}/{what}")


@dataclasses.dataclass(frozen=True)
class SimSettings:
    """The simulator settings of a cell (config and mix together)."""
    n_vcs: int
    buf_depth: int
    cycles: int
    warmup: int
    routing: str
    telemetry: bool
    telemetry_windows: int
    n_rates: int
    single_program: bool


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def settings(config: dict, mix: dict) -> SimSettings:
    sim = config["sim"]
    return SimSettings(
        n_vcs=int(sim["n_vcs"]), buf_depth=int(sim["buf_depth"]),
        cycles=int(sim["cycles"]), warmup=int(sim["warmup"]),
        routing=mix.get("routing", "static"),
        telemetry=bool(mix.get("telemetry", False)),
        telemetry_windows=int(mix.get("telemetry_windows", 0)),
        n_rates=int(config["n_rates"]),
        single_program=bool(mix.get("single_program", False)))


def _traffic_entries(config: dict, mix: dict) -> list:
    entries = mix["traffic"]
    if isinstance(entries, dict):
        entries = [entries]
    out = []
    for e in entries:
        e = dict(e)
        if e.get("kind") not in KINDS:
            raise ValueError(f"traffic kind {e.get('kind')!r} is not one "
                             f"of {KINDS}")
        if e["kind"] in ("collective", "mixed_tenant"):
            e.setdefault("model", config.get("model"))
            e.setdefault("step", config.get("step", {}))
            if not e["model"]:
                raise ValueError(f"{e['kind']} traffic needs a model (in "
                                 f"the configuration or the mix)")
            # a derivation named with no file stops the run here, in set-up
            derivations.load(derivations.name_of(e["step"]))
        out.append(e)
    return out


def scenario_defs(config: dict, mix: dict) -> list:
    """The cell's scenarios, in the order both sides run them."""
    routing = mix.get("routing", "static")
    out = []
    for n in config["sizes"]:
        for area in config["areas_mm2"]:
            for e in _traffic_entries(config, mix):
                for topo in config["topologies"]:
                    out.append(ScenarioDef(
                        index=len(out), topology=topo, n=int(n),
                        substrate=config["substrate"], area=float(area),
                        roles=config.get("roles", "homogeneous"),
                        traffic_json=json.dumps(e, sort_keys=True),
                        routing=routing))
    return out


def model_sizes(model: dict) -> types.SimpleNamespace:
    """A model's published `config.json` numbers as the size fields
    the collective workloads read (ModelConfig's names), and beside them
    every key of `model` under its published name; where the two clash
    (`head_dim`), the mapped field wins."""
    n_experts = int(model.get("num_experts", 0) or 0)
    d_ff = model["moe_intermediate_size"] if n_experts \
        else model["intermediate_size"]
    mapped = dict(
        name=model["name"], d_model=int(model["hidden_size"]),
        n_layers=int(model["num_hidden_layers"]),
        n_heads=int(model["num_attention_heads"]),
        n_kv_heads=int(model["num_key_value_heads"]),
        head_dim=int(model.get("head_dim") or 0),
        d_ff=int(d_ff), vocab=int(model["vocab_size"]),
        n_experts=n_experts,
        top_k=int(model.get("num_experts_per_tok", 0) or 0),
        moe_every=int(model.get("decoder_sparse_step", 1) or 1))
    return types.SimpleNamespace(**{**model, **mapped})


#: keys of a configuration's `step` that are the harness's own: the
#: reference's derivation and the CPU tests' mesh
HARNESS_STEP_KEYS = ("derivation", "tiny_mesh")
#: the step's whole numbers
INT_STEP_KEYS = ("seq_len", "global_batch", "step_cycles", "min_phase",
                 "dtype_bytes")


def step_kwargs(step: dict) -> dict:
    """The training step's keyword arguments of `collective_workload`:
    every key of `step` but the harness's own, with `mesh` handed on as
    `mesh_shape`."""
    kw = {k: int(step[k]) for k in INT_STEP_KEYS if k in step}
    kw.update({k: v for k, v in step.items()
               if k not in kw and k not in HARNESS_STEP_KEYS
               and k != "mesh"})
    if step.get("mesh"):
        kw["mesh_shape"] = {k: int(v) for k, v in step["mesh"].items()}
    return kw


def find(root: Path, kind: str, name: str) -> Path:
    """The file of a configuration ("configs") or mix ("traffic")."""
    path = Path(root) / "perfbench" / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path
