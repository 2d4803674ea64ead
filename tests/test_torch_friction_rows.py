"""The segment friction of the rods app (forces/friction.py:
frictional_segment_contact_rows, remap_row_history) of the torch port vs
the JAX reference, float64 on the CPU, inputs drawn from numpy with a seed.

The contact law follows the reference operation for operation: forces,
torques, the new history and the normal magnitudes within 1e-12 of the
largest of each (the per-row sums may add in another order). The history
remap moves values by pair identity and adds nothing but zeros to them: bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.forces import friction as jf
from mundy_tpu.geom import periodic as jax_periodic
from mundy_tpu_torch.forces import friction as tf
from mundy_tpu_torch.geom.periodicity import periodic as torch_periodic
from mundy_tpu_torch.neighbor.cell_list import build_cell_list, make_cell_grid, neighbor_matrix

torch.set_num_threads(1)

BOX = 8.0
RADIUS = 0.25
HALF = 0.75


def _rods(seed, n=120, k=16):
    """Centers, half-edges, lagged velocities and a prior history on a real
    neighbor matrix (the port's cell list, search radius = half + radius)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    grid = make_cell_grid([0, 0, 0], [BOX] * 3, 2 * (HALF + RADIUS), periodic=(True,) * 3,
                          dtype=torch.float64)
    tpos = torch.from_numpy(pos)
    nmat = neighbor_matrix(tpos, build_cell_list(tpos, grid, 32), HALF + RADIUS,
                           metric=torch_periodic([BOX] * 3, dtype=torch.float64),
                           max_neighbors=k)
    assert not bool(nmat.overflow)
    return dict(pos=pos, hedge=HALF * axis, vel=rng.normal(size=(n, 3)),
                omega=rng.normal(size=(n, 3)), idx=nmat.idx.numpy(),
                mask=nmat.mask.numpy(), tang=1e-3 * rng.normal(size=(n, k, 3)))


@pytest.mark.parametrize("damping", [0.0, 5.0])
@pytest.mark.parametrize("mu", [0.5, 0.02], ids=["stick", "slip"])
def test_frictional_segment_contact_rows(mu, damping):
    """Two friction coefficients (0.02 caps more contacts) and two dampings."""
    d = _rods(0)
    args = ("pos", "hedge", "vel", "omega", "idx", "mask", "tang")
    consts = (2e-3, RADIUS, 1000.0, 0.3, 400.0, mu)
    ref = jf.frictional_segment_contact_rows(
        *(jnp.asarray(d[a]) for a in args), jnp.asarray(2e-3), *consts[1:],
        tang_damping=damping, metric=jax_periodic([BOX] * 3, dtype=jnp.float64))
    got = tf.frictional_segment_contact_rows(
        *(torch.from_numpy(d[a]) for a in args), torch.tensor(2e-3, dtype=torch.float64),
        *consts[1:], tang_damping=damping,
        metric=torch_periodic([BOX] * 3, dtype=torch.float64))
    contacts = int((np.asarray(ref.normal_mag) > 0).sum())
    assert contacts >= 20
    for name in ("forces", "torques", "tang_disp", "normal_mag"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * max(np.abs(r).max(), 1.0),
                                   err_msg=name)


def test_remap_row_history_by_pair_identity():
    """Rebuild the matrix at moved centers and a larger K (a regrow): every
    kept pair carries its history bit for bit, new pairs start at 0."""
    d = _rods(1)
    rng = np.random.default_rng(2)
    moved = torch.from_numpy(d["pos"] + rng.normal(scale=0.2, size=d["pos"].shape))
    grid = make_cell_grid([0, 0, 0], [BOX] * 3, 2 * (HALF + RADIUS), periodic=(True,) * 3,
                          dtype=torch.float64)
    new = neighbor_matrix(moved, build_cell_list(moved, grid, 32), HALF + RADIUS,
                          metric=torch_periodic([BOX] * 3, dtype=torch.float64),
                          max_neighbors=24)
    ref = np.asarray(jf.remap_row_history(
        jnp.asarray(d["idx"]), jnp.asarray(d["mask"]), jnp.asarray(d["tang"]),
        jnp.asarray(new.idx.numpy()), jnp.asarray(new.mask.numpy())))
    got = tf.remap_row_history(torch.from_numpy(d["idx"]), torch.from_numpy(d["mask"]),
                               torch.from_numpy(d["tang"]), new.idx, new.mask)
    assert got.shape == (120, 24, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    kept = (d["idx"][:, None, :] == new.idx.numpy()[:, :, None]) & d["mask"][:, None, :]
    kept &= new.mask.numpy()[:, :, None]
    assert 0 < kept.any(-1).sum() < new.mask.sum()  # some pairs kept, some new
    assert (got.numpy()[~kept.any(-1)] == 0).all()
