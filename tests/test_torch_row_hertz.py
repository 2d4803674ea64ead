"""K6's plain version (ops/kernels/row_hertz.row_hertzian_forces_plain) vs
the JAX reference on the CPU, on the reference's own row layouts.

- float32, the reference test's size (1500 spheres, box 24, from
  RowSpheresSim.init): against the Pallas kernel row_hertzian_forces in
  interpret mode within 5e-5 of max|f|, the bound of
  tests/test_pallas_row_hertz.py (rsqrt approximations and summation
  order); the valid slots' forces sum to ~0 (pair antisymmetry).
- The wrap pair of tests/test_pallas_row_hertz.py: two spheres 0.3 apart
  across the periodic boundary repel, equal and opposite.
- float64: the monodisperse law and the radius variant against the JAX
  app's own non-TPU force (pair_accumulate_central with scalar_fn or, for
  polydispersity 0.4, scalar_fn_poly and the radius payload) within 1e-12
  of max|f| (summation order only).
- A sphere that crossed a periodic y face since the last rebuild (its slot
  in its old row, its position wrapped): K6 takes the minimum image on all
  three axes and finds its contact across the face; the reference's
  pair_accumulate_central (pre-shifted rows, x-only minimum image) does
  not. The port's plain version follows K6 (neighbor/rows.py says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.driver.apps.spheres import SpheresConfig as JaxConfig
from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim as JaxSim
from mundy_tpu.neighbor.rows import build_rows
from mundy_tpu.ops.pallas.row_hertz import row_hertzian_forces as pallas_forces
from mundy_tpu_torch.ops.kernels import row_hertz as k6

torch.set_num_threads(1)
E, NU = 1000.0, 0.3


def _t(a):
    return torch.from_numpy(np.array(a))


def test_k6_plain_matches_pallas_interpret():
    cfg = JaxConfig(num_spheres=1500, box_size=24.0, radius=0.5, diffusion_coeff=0.0,
                    dt=1e-4, skin=0.4, dtype="float32")
    rows = JaxSim(cfg).init().rows
    ref = np.asarray(pallas_forces(rows.pos, rows.valid, [24.0] * 3, 0.5, E, NU,
                                   interpret=True))
    got = k6.row_hertzian_forces(_t(rows.pos), _t(rows.valid), (24.0,) * 3, 0.5, E, NU)
    assert got.dtype == torch.float32
    scale = np.abs(ref).max()
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5 * scale, rtol=0)
    valid = np.asarray(rows.valid)
    assert np.abs(got.numpy()[~valid]).max() == 0.0
    total = got.numpy().reshape(-1, 3)[valid.reshape(-1)].sum(axis=0)
    assert np.abs(total).max() < 1e-2 * scale


def test_k6_plain_periodic_wrap_pair():
    sim = JaxSim(JaxConfig(num_spheres=2, box_size=12.0, radius=0.5, diffusion_coeff=0.0,
                           dtype="float32"))
    pos = jnp.asarray([[0.2, 6.0, 6.0], [11.9, 6.0, 6.0]], jnp.float32)
    rows = build_rows(pos, jnp.arange(2, dtype=jnp.int32), sim.grid)
    ref = np.asarray(pallas_forces(rows.pos, rows.valid, [12.0] * 3, 0.5, E, NU,
                                   interpret=True))
    got = k6.row_hertzian_forces(_t(rows.pos), _t(rows.valid), (12.0,) * 3, 0.5, E, NU)
    fv = got.numpy().reshape(-1, 3)[np.asarray(rows.valid).reshape(-1)]
    # wrapped distance 0.3 < 2r = 1: strong repulsion across the boundary
    assert np.abs(fv).max() > 1.0
    np.testing.assert_allclose(fv.sum(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("polydispersity", [0.0, 0.4])
def test_k6_plain_matches_reference_f64(polydispersity):
    cfg = JaxConfig(num_spheres=1500, box_size=16.0, radius=0.5,
                    polydispersity=polydispersity, diffusion_coeff=0.0, dt=1e-4,
                    skin=0.4, dtype="float64")
    sim = JaxSim(cfg)
    rows = sim.init().rows
    ref = np.asarray(sim._forces(rows))
    radii = None
    if polydispersity:
        safe = np.minimum(np.asarray(rows.gid), cfg.num_spheres - 1)
        radii = _t(np.where(np.asarray(rows.valid), np.asarray(sim.radii)[safe], 0.0))
    got = k6.row_hertzian_forces(_t(rows.pos), _t(rows.valid), (16.0,) * 3, 0.5, E, NU,
                                 radii=radii).numpy()
    scale = np.abs(ref).max()
    assert scale > 1.0
    assert np.abs(got - ref).max() <= 1e-12 * scale


def test_k6_plain_finds_contacts_across_a_face_crossed_since_the_rebuild():
    sim = JaxSim(JaxConfig(num_spheres=2, box_size=12.0, radius=0.5, diffusion_coeff=0.0,
                           dtype="float64"))
    pos = jnp.asarray([[6.0, 0.05, 6.0], [6.0, 11.75, 6.0]])
    rows = build_rows(pos, jnp.arange(2, dtype=jnp.int32), sim.grid)
    # sphere 0 moves across y = 0 and wraps to y = 11.95, without a rebuild
    moved = jnp.where((rows.gid == 0) & rows.valid, 11.95, rows.pos[..., 1])
    rows = rows.replace(pos=rows.pos.at[..., 1].set(moved))
    ref = np.asarray(sim._forces(rows))  # the reference's XLA row force
    kernel = np.asarray(pallas_forces(rows.pos.astype(jnp.float32), rows.valid,
                                      [12.0] * 3, 0.5, E, NU, interpret=True))
    got = k6.row_hertzian_forces(_t(rows.pos), _t(rows.valid), (12.0,) * 3, 0.5, E, NU)
    valid = np.asarray(rows.valid).reshape(-1)
    fv = got.numpy().reshape(-1, 3)[valid]
    assert np.abs(ref).max() == 0.0  # the reference misses the 0.2-apart pair
    assert np.abs(fv[:, 1]).max() > 1.0 and np.abs(fv.sum(axis=0)).max() < 1e-9
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0,
                               atol=5e-5 * np.abs(kernel).max())
