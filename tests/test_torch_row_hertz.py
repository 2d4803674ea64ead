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
- K6's early stop (row_hertz.contact_reach, the kernel's test operation for
  operation) rejects only pairs that the plain version gives an exactly
  zero force, in both dtypes, near contact and near the cut, across the x
  wrap and across a crossed y face.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_early_stop_rejects_only_pairs_that_add_zero(dtype):
    """K6 stops a pair when contact_reach rejects its r2; the plain version
    gives every such pair an exactly zero force. On 600 random spheres of
    radii 0.3-0.7 plus pairs of radii 0.375 and 0.5625 (contact at s =
    0.9375) along x a few ulp either side of contact and of the early
    stop's cut s^2 (1 + 2^-10), the same across the x wrap, and pairs across
    a periodic y face that one of them crossed since the rows were built,
    over the full 9-row stencil with the minimum image on every axis."""
    from mundy_tpu_torch.neighbor import rows as tr

    n, box, ro, rc = 600, 9.0, 0.375, 0.5625
    s = ro + rc
    rng = np.random.default_rng(53)
    pos = rng.uniform(0, box, (n, 3))
    radius = rng.uniform(0.3, 0.7, n)
    eps = float(torch.finfo(dtype).eps)
    cut = s * float(torch.sqrt(torch.tensor(k6.REACH_MARGIN, dtype=torch.float64)))
    # (own x, candidate x, in contact (None: within rounding of s), kept by
    # the early stop, own y moved across y = 0 after the build)
    placed = [(2.0, 2.0 + s * (1 - 1e-3), True, True, False),
              (0.25, 0.25 - s * (1 - 1e-3) + box, True, True, False),
              (7.0, 7.0, False, True, False)]  # coincident
    for k in (-3, -1, 1, 3):
        placed.append((2.0, 2.0 + s * (1 + 4 * k * eps), None if k < 0 else False, True, False))
        placed.append((0.25, 0.25 - s * (1 + 4 * k * eps) + box, None if k < 0 else False,
                       True, False))
        placed.append((5.0, 5.0 + cut * (1 + 8 * k * eps), False, k < 0, False))
    dy = 0.2  # the crossed pairs' y separation, across the face
    for xo, f, touch, kept in ((3.0, np.sqrt(s * s - dy * dy) * (1 - 1e-3), True, True),
                               (4.5, np.sqrt(cut * cut - dy * dy) * (1 - 24 * eps), False, True),
                               (6.0, np.sqrt(cut * cut - dy * dy) * (1 + 24 * eps), False, False)):
        placed.append((xo, xo + f, touch, kept, True))
    for i, (xo, xc, _, _, crossed) in enumerate(placed):
        z = 0.3 + (box - 0.6) * i / len(placed)
        if crossed:  # own in the first row of y, candidate in the last
            pos[2 * i], pos[2 * i + 1] = [xo, 0.1, z], [xc, box - 0.1 - dy, z]
        else:
            pos[2 * i], pos[2 * i + 1] = [xo, z, z], [xc, z, z]
        radius[2 * i], radius[2 * i + 1] = ro, rc
    tg = tr.make_row_grid([0, 0, 0], [box] * 3, 1.8, n, dtype=dtype, align=1)
    ts = tr.build_rows(torch.as_tensor(pos, dtype=dtype), torch.arange(n, dtype=torch.int32), tg)
    gid = torch.where(ts.valid, ts.gid, -1)
    p = ts.pos.clone()
    for i, (_, _, _, _, crossed) in enumerate(placed):
        if crossed:  # the own sphere crosses y = 0: same slot, y wraps to box - 0.1
            p[..., 1] = torch.where(gid == 2 * i, box - 0.1, p[..., 1])
    r = torch.as_tensor(radius, dtype=dtype)[gid.clamp(min=0).long()]
    r = torch.where(ts.valid, r, 0.0)
    boxs = ((box,) * 3, (True,) * 3)
    fields = (ts.valid.to(dtype), r, gid.to(dtype))
    cx, cy, cz, (cv, cr, cg) = tr._candidate_planes(p, boxs, fields)
    ox, oy, oz = p.unbind(-1)
    # the plain version's pair arithmetic, unsummed
    DX, DY, DZ, r2, w = tr.central_pair_terms(
        ox, oy, oz, (ts.valid.to(dtype), r), cx, cy, cz, (cv, cr),
        k6.hertz_scalar_fn(0.5, E, NU, dtype, "cpu"), ((box, 1.0 / box),) * 3)
    terms = torch.stack([w * DX, w * DY, w * DZ], dim=-1)
    keep = k6.contact_reach(r2, r[..., :, None], cr[..., None, :])
    assert bool((terms[~keep] == 0).all())
    og = gid.to(dtype)[..., :, None].expand_as(keep)
    cg = cg[..., None, :].expand_as(keep)
    both = (og >= 0) & (cg >= 0)
    assert 0.9 < float((~keep[both]).double().mean()) < 1.0
    assert bool((terms[keep & both].abs().amax(-1) > 0).any())
    for i, (_, _, touch, kept, _) in enumerate(placed):
        pair = (og == 2 * i) & (cg == 2 * i + 1)
        assert int(pair.sum()) == 1
        assert bool(keep[pair]) == kept
        if touch is not None:
            assert bool(terms[pair].abs().max() > 0) == touch
