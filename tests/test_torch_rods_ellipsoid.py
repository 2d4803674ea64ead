"""The ellipsoid narrow phase of the (N, K) rods engine: the torch RodsSim
vs the JAX RodsSim, float64 on the CPU, with both noises on.

Rods of length 0.5 and radius 0.25 (prolate ellipsoids with semi-axes
(0.25, 0.25, 0.5)): at this aspect the reference's projected gradient
descent contracts, so the two packages' rounding differences die out in
it. The JAX init's state goes across; a block with a rebuild (the cold
7-start sweep re-seeds every slot) and warm steps, then a regrow (K 16 ->
32, re-seeded cold). Rebuild counts, neighbor ids, masks and overflow must
be equal; positions and quaternions agree within 1e-8, the warm normals
within 1e-6: the cold sweep's pick among starts that reach one minimum
compares objective values equal to rounding, which moves a normal by up to
sqrt(eps / c) for an objective of curvature c there (~1e-7 on contacts,
tests/test_torch_distance.py; 1.4e-7 measured on a pair far from contact,
where the objective is flatter), and a contact force by that fraction.

At the app's default aspect (length 2: semi-axes (0.25, 0.25, 1.25)) the
descent does not contract: rounding differences grow ~5x per iteration, a
pair's normal ends in a basin that rounding picks, and the two packages'
trajectories part within a few steps (both engines alike; ROADMAP queue
3). The JAX init and regrow run under jax.jit here (the same functions,
compiled once instead of dispatched op by op).
"""

import jax
import numpy as np
import torch

from mundy_tpu.driver.apps.rods import RodsConfig as JaxConfig
from mundy_tpu.driver.apps.rods import RodsSim as JaxSim
from mundy_tpu_torch.driver.apps.rods import RodsConfig, RodsSim

torch.set_num_threads(2)

KW = dict(num_rods=200, box_size=8.0, length=0.5, radius=0.25, diffusion_coeff=0.05,
          rot_diffusion_coeff=0.05, dt=1e-4, skin=0.1, max_neighbors=16,
          shape="ellipsoid", dtype="float64")


def _same(js, ts):
    assert ts.step == int(js.step)
    assert ts.rebuild_count == int(js.rebuild_count)
    np.testing.assert_array_equal(ts.nmat.idx.numpy(), np.asarray(js.nmat.idx))
    np.testing.assert_array_equal(ts.nmat.mask.numpy(), np.asarray(js.nmat.mask))
    assert bool(ts.overflow) == bool(js.overflow)
    for name, tol in (("pos", 1e-8), ("quat", 1e-8), ("warm_n", 1e-6)):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=tol, err_msg=name)


def test_ellipsoid_rods_match_reference():
    jsim = JaxSim(JaxConfig(**KW))
    tsim = RodsSim(RodsConfig(**KW), device="cpu")
    js = jax.jit(jsim.init)()
    ts = tsim.init(pos=np.array(js.pos), quat=np.array(js.quat),
                   key_words=np.asarray(jax.random.key_data(js.key)))
    _same(js, ts)
    assert float(ts.warm_n.norm(dim=-1)[ts.nmat.mask].min()) > 0.999  # every slot seeded
    js, ts = jsim.run_block(js, 8), tsim.run_block(ts, 8)
    assert ts.rebuild_count >= 2
    _same(js, ts)
    # the narrow phase reached contacts (the force path ran)
    res = tsim._ellipsoid_narrow(ts.pos, ts.quat, ts.nmat, ts.warm_n)
    assert int(((res.dist < 0) & ts.nmat.mask).sum()) > 10
    js, ts = jax.jit(jsim.regrow)(js), tsim.regrow(ts)
    assert tsim.config.max_neighbors == jsim.config.max_neighbors == 32
    _same(js, ts)
