"""The sharded filaments engine (parallel/filaments_shard.py) and the
filaments route of ShardedSim on 2 gloo ranks on the CPU (one process group
for the file, whose ranks import no JAX), float64, at the reference test's
size (tests/test_filaments_shard.py: 16 filaments x 8 nodes in a box of 18,
the active wave on), against the JAX engine over a 2-device mesh and the
port's single-device FilamentsSim on its cell-list (`nmat`) engine.

- Two blocks of 20 steps from the JAX app's init: within 1e-7 of the JAX
  engine after each (the reference's bar against its single-device app,
  which the port's keyed noise and sums hold too), and within 1e-7 of the
  port's FilamentsSim, with its rebuild count.
- ShardedSim("filaments") over two blocks of 10 steps, max_neighbors cut to
  2 so that the first block overflows: the route grows max_neighbors and
  cell_capacity, and ends within 1e-7 of FilamentsSim.
- `main --devices 2 --device cpu` runs the repo's filaments_sperm,
  hp1_chromatin and chromatin_1m_spectral YAMLs (cut to the CPU) on the two
  block routes: the plan and decomposition lines and one "stepped" line
  once (rank 0 prints), the checkpoint written.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.driver.apps.filaments import FilamentsConfig as JConfig
from mundy_tpu.driver.apps.filaments import FilamentsSim as JSim
from mundy_tpu.parallel.filaments_shard import make_sharded_filaments_step as jax_make
from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
from mundy_tpu_torch.parallel.comm import spawn_ranks

D = 2
KW = dict(num_filaments=16, nodes_per_filament=8, segment_length=1.0, radius=0.25,
          box_size=18.0, bend_modulus=5.0, stretch_stiffness=200.0, diffusion_coeff=0.02,
          active_amplitude=0.2, wave_omega=20.0, dt=2e-4, max_neighbors=24, cell_capacity=32,
          dtype="float64", chunk=256, log_every=1000)
BLOCKS = (20, 20)
ROUTE_BLOCKS = (10, 10)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    jsim = JSim(JConfig(**KW))
    js0 = jsim.init()
    pos0 = np.array(js0.pos)
    key = tuple(int(k) for k in np.asarray(jax.random.key_data(js0.key)))
    jobs = [("engine", bodies.filaments_engine, (FilamentsConfig(**KW), pos0, key, BLOCKS)),
            ("route", bodies.block_route, ("filaments", FilamentsConfig(**KW), ROUTE_BLOCKS,
                                           dict(pos=torch.as_tensor(pos0), key_words=key), 2))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    shard_fn, step_fn, gather_fn = jax_make(mesh, "shard", jsim)
    sh, ref = shard_fn(js0), []
    for n in BLOCKS:
        sh = step_fn(sh, n)
        ref.append(gather_fn(sh))
    return port, ref, pos0, key


def _single(pos0, key, blocks):
    sim = FilamentsSim(FilamentsConfig(**KW), device="cpu")
    st, out = sim.init(pos=torch.as_tensor(pos0), key_words=key), []
    for n in blocks:
        st = sim.run_block(st, n)
        out.append(st)
    return out


@pytest.mark.parametrize("block", [0, 1])
def test_engine_matches_jax_and_single_device(runs, block):
    port, ref, pos0, key = runs
    got = port["engine"][block]
    jpos, jovf = ref[block]
    assert not got["overflow"] and not jovf
    assert got["step"] == sum(BLOCKS[:block + 1])
    assert np.abs(got["pos"] - jpos).max() < 1e-7
    st = _single(pos0, key, BLOCKS)[block]
    assert np.abs(got["pos"] - st.pos.numpy()).max() < 1e-7
    assert got["rebuilds"] == st.rebuild_count


def test_route_regrows_and_matches_single_device(runs):
    port, _, pos0, key = runs
    got = port["route"]
    assert got["regrows"] >= 1 and got["k"] > 2 and got["step"] == sum(ROUTE_BLOCKS)
    assert got["describe"] == ("sharded over 2 ranks: the whole-filament block filaments "
                               "engine, 8 filaments per rank")
    st = _single(pos0, key, ROUTE_BLOCKS)[-1]
    assert np.abs(got["pos"] - st.pos.numpy()).max() < 1e-7


def test_no_rank_imported_jax(runs):
    assert not runs[0]["jax_imported"]


# the repo's example YAMLs of the two block routes, cut to the CPU
CLI_RUNS = {
    "filaments_sperm": ("num_filaments=8", "num_steps=20", "dtype=float64"),
    "hp1_chromatin": ("num_chains=2", "beads_per_chain=40", "num_crosslinkers=16",
                      "periphery_radius=8.0", "periphery_order=6", "num_steps=10",
                      "dtype=float64"),
    "chromatin_1m_spectral": ("num_chains=2", "beads_per_chain=32", "num_crosslinkers=16",
                              "box_size=16.0", "num_steps=4", "dtype=float64"),
}


@pytest.mark.parametrize("yaml", sorted(CLI_RUNS))
def test_main_devices_two_runs_the_block_routes(yaml, tmp_path, capfd):
    from mundy_tpu_torch.driver.main import main

    sets = CLI_RUNS[yaml]
    steps = int(next(v for v in sets if v.startswith("num_steps=")).split("=")[1])
    ck = tmp_path / "ck"
    assert main([f"examples/{yaml}.yaml", "--device", "cpu", "--devices", "2", "--set", *sets,
                 "--checkpoint-dir", str(ck), "--rank-timeout", "240"]) == 0
    said = capfd.readouterr().out
    assert said.count("ranks 2, backend gloo, devices [cpu, cpu]") == 1
    assert said.count("sharded over 2 ranks: the whole-") == 1
    assert said.count(f"step {steps}/{steps}") == 1  # rank 0 alone prints
    assert sorted(p.name for p in ck.iterdir()) == [f"ckpt_{steps:012d}.json",
                                                   f"ckpt_{steps:012d}.npz"]
