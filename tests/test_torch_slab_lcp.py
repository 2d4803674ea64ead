"""The volume-allocated z-slab LCP engine (parallel/slab_lcp.py) over 4
gloo ranks on the CPU against the JAX engine over a 4-device mesh, float64,
one process group for the file.

The reference test's config (tests/test_parallel_lcp.py:43-78): 512
overlapping spheres at volume fraction 0.05, dt 1e-3, BBPGD tolerance 1e-9,
pair capacity 8 per body, no noise, one block of 30 steps. The port starts
from the JAX init's state carried through core.interop (which equals the
port's own init from the same draws), in each rebuild mode:
- gid and valid are bit-equal per slot, the positions agree within 1e-9,
  the last solve's BBPGD iterations are equal, and every rank took the same
  iterations at every step;
- the positions agree with the port's single-device LCPSpheresSim over the
  same 30 steps within 1e-5, the reference test's bar.
With the keyed noise (D 0.05) the local mode migrates across slab faces at
its skin rebuilds; there the iterations are equal and the positions agree
within 1e-7, the bound the two packages' float32 Brownian normals allow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.parallel.slab_lcp import make_slab_lcp_spheres_step as jax_make
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.parallel.comm import spawn_ranks

D, N, RADIUS, STEPS = 4, 512, 0.5, 30
BOX = float((N * (4 / 3) * np.pi * RADIUS ** 3 / 0.05) ** (1 / 3))
KW = dict(n_total=N, box_size=BOX, radius=RADIUS, dt=1e-3, max_allowable_overlap=1e-9,
          pair_capacity_per_body=8)
CASES = {"local": ("local", 0.0), "global": ("global", 0.0), "local-noise": ("local", 0.05)}
BARS = {"local": 1e-9, "global": 1e-9, "local-noise": 1e-7}


def _flat(pos, valid, gid):
    """Row-layout (ny, nz, R, ...) arrays -> (N, 3) positions by gid."""
    out = np.zeros((N, 3))
    v = valid.reshape(-1)
    out[gid.reshape(-1)[v]] = pos.reshape(-1, 3)[v]
    return out


def _min_image(diff):
    return diff - BOX * np.round(diff / BOX)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    raw = np.random.default_rng(5).uniform(0.0, BOX, (N, 3))
    ref, starts = {}, {}
    for name, (mode, noise) in CASES.items():
        init, step, _grid = jax_make(mesh, "shard", dtype=jnp.float64, rebuild_mode=mode,
                                     diffusion=noise, **KW)
        st = init(jax.random.PRNGKey(0), pos=raw)
        starts[name] = {k: np.asarray(v) for k, v in st.items() if k != "key"}
        starts[name].update(key=np.asarray(jax.random.key_data(st["key"])), raw=raw)
        st = step(st, STEPS)
        ref[name] = {k: np.asarray(st[k]) for k in ("pos", "valid", "gid", "lcp_iters",
                                                     "overflow")}
    jobs = [(name, bodies.slab_lcp_run, (dict(KW, diffusion=noise), starts[name], mode, STEPS))
            for name, (mode, noise) in CASES.items()]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=170.0)[0]
    return raw, ref, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_lcp_rows_match_reference(runs, case):
    _, ref, port = runs
    want, got = ref[case], port[case]
    assert got["init_equal"]  # the carried JAX state is the port's own init
    assert got["mode"] == CASES[case][0]
    assert np.array_equal(got["gid"], want["gid"])
    assert np.array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_allclose(got["pos"][v], want["pos"][v], rtol=0, atol=BARS[case])
    assert not got["overflow"] and not bool(want["overflow"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_lcp_iterations_match_reference(runs, case):
    _, ref, port = runs
    got = port[case]
    assert got["iters_agree"]
    assert got["lcp_iters"] == got["iters"][-1] == int(ref[case]["lcp_iters"][0])
    assert len(got["iters"]) == STEPS and max(got["iters"]) > 0


def test_slab_lcp_noise_rebuilds_locally(runs):
    _, _, port = runs
    assert port["local-noise"]["rebuilds"] >= 2


@pytest.mark.parametrize("case", ["local", "global"])
def test_slab_lcp_matches_single_device_sim(runs, case):
    """The reference's bar against the single-device LCP line."""
    raw, _, port = runs
    got = port[case]
    sim = LCPSpheresSim(LCPSpheresConfig(num_spheres=N, box_size=BOX, radius=RADIUS, dt=1e-3,
                                         max_allowable_overlap=1e-9, dtype="float64",
                                         num_steps=STEPS), device="cpu")
    st = sim.run_block(sim.init(pos=torch.as_tensor(raw)), STEPS)
    assert not bool(st.overflow)
    diff = _min_image(st.pos.numpy() - _flat(got["pos"], got["valid"], got["gid"]))
    assert np.abs(diff).max() < 1e-5


def test_slab_lcp_ranks_import_no_jax(runs):
    assert not runs[2]["jax_imported"]
