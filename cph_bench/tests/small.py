"""Tiny cells for the CPU tests: each benchmark cell's configuration and
mix cut to a box the CPU runs in seconds (the builders, drivers,
reference and limits unchanged), and a PME replica-exchange cell that
exists only here, so that every driver runs."""
import copy
import json
import os

from cph_bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the acid in 3,001 atoms of rigid SPC/E water with PME (mesh 24³), for
# the tiled_rex driver
ACID = {
    "name": "acid_pme_tiny",
    "builder": {"module": "water", "function": "solvated_acid",
                "params": {"n_side": 10, "spacing": 3.2, "pK": 4.25,
                           "pH": 5.0, "cutoff": 8.0, "skin": 0.8,
                           "coul_style": "cut", "alpha": 0.30,
                           "hmr": 3.0}},
    "split": {"skin": 0.8, "tile_safety": 1.72},
    "shape": None,
    "pme": {"alpha": 0.30, "spacing": 1.5, "p": 6, "mesh": [24, 24, 24]},
    "relax": {"fire_steps": 16, "steps": 16, "margin": 8,
              "engine": {"dt": 0.5, "thermostat": "langevin", "T": 300.0,
                         "gamma": 0.01, "lambda_frozen": True,
                         "rebuild_every": 8, "force_cap": 50.0}},
    "engine": {"dt": 2.0, "thermostat": "langevin", "T": 300.0,
               "gamma": 0.002, "lambda_thermostat": "langevin",
               "lambda_gamma": 0.05, "lam_min": -0.12, "lam_max": 1.12,
               "rebuild_every": 12, "kspace_every": 2},
    "dG_ref": 0.0,
    "limits": {"force_gap": 2e-3, "energy_gap": 1e-4,
               "lambda_force_gap": 2e-4, "constraint_gap": 1e-4,
               "step_noise_dev": 0.08},
}
TEST_ONLY = {"acid_pme_tiny.rex_r16": (ACID, "rex_r16")}
PME_MS = {"name": "pme_ms", "unit": "ms", "better": "lower",
          "source": "program_span", "layer": "k-space", "moves":
          "ns_per_day"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load(name):
    if name not in TEST_ONLY:
        return copy.deepcopy(harness.load_cell(ROOT, name))
    config, mix_name = TEST_ONLY[name]
    bench = _bench()
    with open(os.path.join(ROOT, "cph_bench", "traffic",
                           mix_name + ".json")) as fh:
        mix = json.load(fh)
    return harness.Cell(root=ROOT, name=name, config=copy.deepcopy(config),
                        mix=mix, chips=1,
                        end_to_end=bench["end_to_end"],
                        per_layer=bench["per_layer"] + [PME_MS])


def cell(name, **mix_changes):
    """The named cell at a tiny size: the polypeptide of 8 residues in
    2,100 atoms at rc 6 Å, or the acid above; two replicas, 12-step
    blocks, 16 + 16 relaxation steps."""
    c = _load(name)
    cfg, mix = c.config, c.mix
    if name not in TEST_ONLY:
        cfg["builder"]["params"].update(n_residues=8, box_len=30.0,
                                        cutoff=6.0, n_buffer_waters=2)
        cfg["shape"] = None
        cfg["relax"].update(fire_steps=16, steps=16)
        cfg["relax"].pop("W", None)
    mix["phs"] = mix["phs"][1::len(mix["phs"]) // 2][:2]
    mix["walkers_per_ph"] = 1
    mix["steps_per_block"] = 12
    if "metad" in mix:
        mix["metad"]["stride"] = 12
    mix.update(mix_changes)
    return c


def bench_cells():
    return [w["name"] for w in _bench()["workloads"]]


def cells():
    """Every driver's cell: the benchmark's and the test-only ones."""
    return bench_cells() + list(TEST_ONLY)
