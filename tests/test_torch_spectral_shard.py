"""The sharded spectral-Ewald mobility and its two building blocks: the
port vs the JAX package, float64 on the CPU from the same seeded numpy
inputs, the port's ranks on 2 gloo processes (one process group for the
file, whose ranks import no JAX) against a 2-device mesh.

- `neighbor_matrix_query`: the rows of a scattered subset of bodies, with
  padding queries, the bonded `exclude` table, periodic and free space, are
  `torch.equal` to the matching rows of the port's `neighbor_matrix` and
  equal to the JAX function's.
- `pair_apply_cells3d(x_range=)`: each x-slab of the real-space RPY scan
  matches the JAX slab (1e-12 of the max), and the slabs of 2 and 3 ranks,
  the overlap where d does not divide nx masked as the sharded apply masks
  it, add up to the whole scan (1e-12).
- `make_sharded_se_rpy_apply` over 2 ranks, the rows and the tile
  geometry: within the reference's 1e-9 of max|u| of the port's
  single-device `se_rpy_apply_cells`, and within the float32 FFT's rounding
  (1e-6 of the max, tests/test_torch_spectral.py) of the JAX sharded apply;
  no overflow. Every body in one binning column trips the overflow flag on
  every rank, as in the reference's test.
- `ChromatinSim(mesh=group)` with rpy_spectral: 8 steps within 1e-8 of the
  single-device sim; a mesh that is not a Group, N % d != 0 and another
  hydro mode raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_rank_bodies as bodies
from mundy_tpu.mobility import spectral as jsp
from mundy_tpu.neighbor import cell_list as jcl
from mundy_tpu.neighbor import cells3d as jc
from mundy_tpu.parallel.spectral_shard import make_sharded_se_rpy_apply as jax_apply
from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
from mundy_tpu_torch.geom.periodicity import periodic
from mundy_tpu_torch.mobility import ewald as tew
from mundy_tpu_torch.mobility import spectral as tsp
from mundy_tpu_torch.neighbor import cell_list as tcl
from mundy_tpu_torch.neighbor import cells3d as tc
from mundy_tpu_torch.parallel.comm import Group, spawn_ranks

D = 2
N, BOX = 1024, 18.0
FFT_TOL = 1e-6
MESH_CFG = dict(num_chains=2, beads_per_chain=32, bead_radius=0.5, num_crosslinkers=0,
                diffusion_coeff=0.0, dt=2e-4, hydro="rpy_spectral", box_size=16.0,
                dtype="float64", chunk=256, log_every=1000)
MESH_STEPS = 8


@functools.lru_cache(maxsize=None)
def _ops():
    """(JAX, port) float64 operators of the test box."""
    return (jsp.build_spectral_ewald(BOX, 0.5, 1.0, tol=1e-4, n_particles=N, dtype=jnp.float64),
            tsp.build_spectral_ewald(BOX, 0.5, 1.0, tol=1e-4, n_particles=N,
                                     dtype=torch.float64))


def se_inputs():
    rng = np.random.default_rng(3)
    return rng.uniform(0, BOX, (N, 3)), rng.normal(size=(N, 3))


def column_inputs():
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, BOX, (128, 3))
    pos[:, 1:] = 0.5  # every body in one (y, z) binning column
    return pos, rng.normal(size=(128, 3))


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    pos, f = se_inputs()
    cpos, cf = column_inputs()
    jobs = [("rows", bodies.se_sharded, (BOX, N, "rows", pos, f, 3.0)),
            ("tiles", bodies.se_sharded, (BOX, N, "tiles", pos, f, 3.0)),
            ("column", bodies.se_sharded, (BOX, 128, "column", cpos, cf, 1.15)),
            ("mesh", bodies.chromatin_mesh, (ChromatinConfig(**MESH_CFG), MESH_STEPS))]
    port = spawn_ranks(bodies.run_all, D, "cpu", args=(jobs,), timeout=240.0)[0]
    # the JAX sharded apply over a 2-device mesh, each geometry
    mesh = Mesh(np.array(jax.devices()[:D]), ("shard",))
    op = _ops()[0]
    grid = jc.make_cell_grid3d([BOX] * 3, op.base.r_cut, N, dtype=jnp.float64)
    ref = {}
    for kind, make in (("rows", jsp.make_se_geometry), ("tiles", jsp.make_se_geometry_tiles)):
        geom = make(op, N // D, capacity_slack=3.0)
        apply_fn, shard = jax_apply(mesh, "shard", op, geom, grid, N, (BOX,) * 3,
                                    dtype=jnp.float64)
        u, ovf = apply_fn(jax.device_put(jnp.asarray(pos), shard),
                          jax.device_put(jnp.asarray(f), shard))
        ref[kind] = (np.asarray(u), bool(ovf))
    return port, ref


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# ---- neighbor_matrix_query ----------------------------------------------------


@pytest.mark.parametrize("space", ["periodic", "free"])
def test_neighbor_matrix_query_rows(space):
    rng = np.random.default_rng(21)
    n, box, per_chain = 700, 9.0, 10
    pos = rng.uniform(0, box, (n, 3)) if space == "periodic" else rng.normal(0, 2.5, (n, 3))
    bead = np.arange(n)
    excl = np.stack([np.where(bead % per_chain > 0, bead - 1, -1),
                     np.where(bead % per_chain < per_chain - 1, bead + 1, -1)], 1)
    gid = np.sort(rng.choice(n, 130, replace=False))  # a scattered subset
    radius, K = 0.55, 24
    f64 = torch.float64
    tpos = torch.as_tensor(pos)
    if space == "periodic":
        low, high, per = [0.0] * 3, [box] * 3, (True,) * 3
        metric = periodic([box] * 3, dtype=f64, device="cpu")
    else:
        low, high, per = [-9.0] * 3, [9.0] * 3, (False,) * 3
        metric = None
    grid = tcl.make_cell_grid(low, high, 2 * radius, per, dtype=f64, device="cpu")
    clist = tcl.build_cell_list(tpos, grid, 16)
    texcl = torch.as_tensor(excl, dtype=torch.int32)
    full = tcl.neighbor_matrix(tpos, clist, radius, metric=metric, max_neighbors=K, chunk=256,
                               exclude=texcl)
    g = torch.as_tensor(gid)
    sub = tcl.neighbor_matrix_query(tpos, clist, tpos[g], g, radius, metric=metric,
                                    max_neighbors=K, chunk=48, exclude=texcl[g])
    assert not bool(clist.overflow) and not bool(full.overflow) and not bool(sub.overflow)
    assert int(sub.mask.sum()) > 0 and int(full.mask.sum(1).max()) < K
    assert torch.equal(sub.idx, full.idx[g]) and torch.equal(sub.mask, full.mask[g])
    # the JAX query on the same inputs
    jmetric = None
    if space == "periodic":
        from mundy_tpu.geom.periodicity import periodic as jperiodic

        jmetric = jperiodic([box] * 3, dtype=jnp.float64)
    jgrid = jcl.make_cell_grid(low, high, 2 * radius, per, dtype=jnp.float64)
    jpos = jnp.asarray(pos)
    jlist = jcl.build_cell_list(jpos, jgrid, 16)
    jsub = jcl.neighbor_matrix_query(jpos, jlist, jpos[gid], jnp.asarray(gid, jnp.int32),
                                     jnp.asarray(radius, jnp.float64), metric=jmetric,
                                     max_neighbors=K, chunk=48,
                                     exclude=jnp.asarray(excl[gid], jnp.int32))
    np.testing.assert_array_equal(sub.idx.numpy(), np.asarray(jsub.idx))
    np.testing.assert_array_equal(sub.mask.numpy(), np.asarray(jsub.mask))
    # padding queries (gid -1) find nothing
    pad = tcl.neighbor_matrix_query(tpos, clist, tpos[[5, 0, 7]], torch.tensor([-1, 0, -1]),
                                    radius, metric=metric, max_neighbors=K, chunk=4)
    assert not bool(pad.mask[0].any()) and not bool(pad.mask[2].any())
    assert torch.equal(pad.idx[1], tcl.neighbor_matrix(tpos, clist, radius, metric=metric,
                                                       max_neighbors=K, chunk=256).idx[0])


# ---- pair_apply_cells3d(x_range=) ----------------------------------------------


@pytest.fixture(scope="module")
def scans():
    """Both packages' 3D cells, payload and real-space kernel over the
    inputs, and the port's whole scan."""
    from mundy_tpu.mobility.ewald import rpy_real_cells_kernel as jker

    pos, f = se_inputs()
    jops, tops = _ops()
    tgrid = tc.make_cell_grid3d([BOX] * 3, tops.base.r_cut, N, dtype=torch.float64)
    jgrid = jc.make_cell_grid3d([BOX] * 3, jops.base.r_cut, N, dtype=jnp.float64)
    tcells = tc.build_cells3d(torch.as_tensor(pos), tgrid)
    jcells = jc.build_cells3d(jnp.asarray(pos), jgrid)
    t = (tcells, tc.gather_from_flat(tcells, torch.as_tensor(f)),
         tew.rpy_real_cells_kernel(tops.base))
    j = (jcells, jc.gather_from_flat(jcells, jnp.asarray(f)), jker(jops.base))
    return t, j, tc.pair_apply_cells3d(t[0], (BOX,) * 3, t[1], t[2], 3)


@pytest.mark.parametrize("d", [2, 3])
def test_pair_apply_cells3d_x_slabs(scans, d):
    (tcells, tpay, tker), (jcells, jpay, jker), whole = scans
    nx = tcells.grid.nx
    nxl = -(-nx // d)
    assert nx == 4  # at d = 3 the last slab overlaps its neighbour's wholly
    owned_sum = torch.zeros_like(whole)
    scale = float(whole.abs().max())
    for r in range(d):
        x0 = min(r * nxl, nx - nxl)
        slab = tc.pair_apply_cells3d(tcells, (BOX,) * 3, tpay, tker, 3, x_range=(x0, nxl))
        jslab = jc.pair_apply_cells3d(jcells, (BOX,) * 3, jpay, jker, 3, x_range=(x0, nxl))
        assert np.abs(slab.numpy() - np.asarray(jslab)).max() <= 1e-12 * scale
        for i in range(nxl):
            if r * nxl <= x0 + i < min((r + 1) * nxl, nx):
                owned_sum[x0 + i] += slab[i]
    assert float((owned_sum - whole).abs().max()) <= 1e-12 * scale
    with pytest.raises(ValueError, match="x_range"):
        tc.pair_apply_cells3d(tcells, (BOX,) * 3, tpay, tker, 3, x_range=(3, 2))


# ---- the sharded apply ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rows", "tiles"])
def test_sharded_se_apply(runs, kind):
    port, ref = runs
    got = port[kind]
    assert not got["overflow"] and not ref[kind][1]
    pos, f = se_inputs()
    op = _ops()[1]
    grid = tc.make_cell_grid3d([BOX] * 3, op.base.r_cut, N, dtype=torch.float64)
    geom = (tsp.make_se_geometry if kind == "rows" else tsp.make_se_geometry_tiles)(op, N)
    tp, tf = torch.as_tensor(pos), torch.as_tensor(f)
    u, ovf = tsp.se_rpy_apply_cells(op, tc.build_cells3d(tp, grid), tp, tf, (BOX,) * 3, geom)
    assert not bool(ovf)
    assert _rel(got["u"], u.numpy()) <= 1e-9
    assert _rel(got["u"], ref[kind][0]) <= FFT_TOL


def test_sharded_se_flags_binning_overflow(runs):
    port, _ = runs
    assert port["column"]["overflow"]


def test_chromatin_mesh_matches_single_device(runs):
    port, _ = runs
    got = port["mesh"]
    assert got["sharded"] and not got["overflow"]
    sim = ChromatinSim(ChromatinConfig(**MESH_CFG), device="cpu")
    st = sim.run_block(sim.init(), MESH_STEPS)
    assert not bool(st.overflow)
    diff = got["pos"] - st.pos.numpy()
    diff -= MESH_CFG["box_size"] * np.round(diff / MESH_CFG["box_size"])
    assert np.abs(diff).max() < 1e-8


def test_chromatin_mesh_refusals():
    cfg = ChromatinConfig(**MESH_CFG)
    with pytest.raises(TypeError, match="Group"):
        ChromatinSim(cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="N % ranks"):
        ChromatinSim(cfg, device="cpu", mesh=Group(0, 3, "cpu", "gloo"))
    dry = ChromatinConfig(**{**MESH_CFG, "hydro": "none", "box_size": 0.0})
    with pytest.raises(ValueError, match="rpy_spectral"):
        ChromatinSim(dry, device="cpu", mesh=Group(0, 2, "cpu", "gloo"))


def test_no_rank_imported_jax(runs):
    assert not runs[0]["jax_imported"]
