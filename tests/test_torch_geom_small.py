"""The small modules of the torch port vs the JAX reference, float64 on the
CPU, inputs drawn from numpy with a seed: math/linalg and math/quaternion
(the rest of each), math/tolerance, geom/primitives, geom/aabb,
geom/transform, mech/joints and state/fieldops, every result within 1e-12
(the same operations; a sum may add in another order). The random
generators (geom/randomize, field_randomize) draw from torch.Generators,
whose bits cannot be JAX's: they are held to shapes, ranges and Haar
orientations, as tests/test_geom_aabb.py::test_randomize holds the
reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.geom import aabb as ja
from mundy_tpu.geom import primitives as jp
from mundy_tpu.geom import transform as jt
from mundy_tpu.math import linalg as jl
from mundy_tpu.math import quaternion as jq
from mundy_tpu.math import tolerance as jtol
from mundy_tpu.mech import joints as jj
from mundy_tpu.state import fieldops as jf
from mundy_tpu_torch.geom import aabb as ta
from mundy_tpu_torch.geom import primitives as tp
from mundy_tpu_torch.geom import randomize as tr
from mundy_tpu_torch.geom import transform as tt
from mundy_tpu_torch.math import linalg as tl
from mundy_tpu_torch.math import quaternion as tq
from mundy_tpu_torch.math import tolerance as ttol
from mundy_tpu_torch.mech import joints as tj
from mundy_tpu_torch.state import fieldops as tf

torch.set_num_threads(1)

N = 40


def _unit(rng, n, d):
    v = rng.normal(size=(n, d))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def data():
    rng = np.random.default_rng(21)
    return {"p": rng.uniform(-2, 2, (N, 3)), "p2": rng.uniform(-2, 2, (N, 3)),
            "q": _unit(rng, N, 4), "q2": _unit(rng, N, 4), "u": _unit(rng, N, 3),
            "r": rng.uniform(0.2, 0.8, N), "r2": rng.uniform(0.1, 0.4, N),
            "len": rng.uniform(0.5, 2.0, N), "radii": rng.uniform(0.3, 1.0, (N, 3)),
            "t": rng.uniform(0, 1, N)}


def _close(got, ref, tol=1e-12):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, tol)
        return
    if hasattr(ref, "__dataclass_fields__"):
        for name in ref.__dataclass_fields__:
            _close(getattr(got, name), getattr(ref, name), tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=tol)


def _sides(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _prims(P, x):
    """One of each primitive on the inputs `x`."""
    return {
        "sphere": P.Sphere(center=x["p"], radius=x["r"]),
        "line": P.Line(point=x["p"], direction=x["u"]),
        "segment": P.LineSegment(start=x["p"], end=x["p2"]),
        "vsegment": P.VSegment(start=x["p"], middle=x["p2"], end=x["p"] * 0.5),
        "plane": P.Plane(point=x["p"], normal=x["u"]),
        "circle": P.Circle3D(center=x["p"], orientation=x["q"], radius=x["r"]),
        "ring": P.Ring(center=x["p"], orientation=x["q"], major_radius=x["r"],
                       minor_radius=x["r2"]),
        "spherocylinder": P.Spherocylinder(center=x["p"], orientation=x["q"], radius=x["r"],
                                           length=x["len"]),
        "scsegment": P.SpherocylinderSegment(start=x["p"], end=x["p2"], radius=x["r"]),
        "ellipsoid": P.Ellipsoid(center=x["p"], orientation=x["q"], radii=x["radii"]),
        "aabb": P.AABB(min=x["p"] - 1.0, max=x["p"] + x["radii"]),
    }


def test_linalg_and_quaternion_rest(data):
    j, t = _sides(data)
    _close(tl.norm_sq(t["p"]), jl.norm_sq(j["p"]))
    _close(tl.outer(t["p"], t["u"]), jl.outer(j["p"], j["u"]))
    z = np.zeros((N, 3))
    z[::3] = data["p"][::3]
    for eps in (0.0, 1e-12):
        ref = jl.normalize(jnp.asarray(z) + (0 if eps else 1.0), eps=eps)
        _close(tl.normalize(torch.from_numpy(z) + (0 if eps else 1.0), eps=eps), ref)
    _close(tq.quat_identity((2, 3), dtype=torch.float64), jq.quat_identity((2, 3), jnp.float64))
    _close(tq.quat_inverse_rotate(t["q"], t["p"]), jq.quat_inverse_rotate(j["q"], j["p"]))
    _close(tq.quat_from_axis_angle(t["u"], t["t"] * 6.0),
           jq.quat_from_axis_angle(j["u"], j["t"] * 6.0))
    _close(tq.quat_to_matrix(t["q"]), jq.quat_to_matrix(j["q"]))
    near = data["q"] + 1e-9 * data["q2"]  # the lerp branch
    for q1 in (data["q2"], -data["q2"], near):
        _close(tq.quat_slerp(t["q"], torch.from_numpy(q1), t["t"]),
               jq.quat_slerp(j["q"], jnp.asarray(q1), j["t"]))


def test_tolerance_tables():
    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32),
                   (jnp.float16, torch.float16), (jnp.bfloat16, torch.bfloat16),
                   (jnp.int32, torch.int32)):
        assert ttol.get_zero_tolerance(td) == jtol.get_zero_tolerance(jd)
        if td.is_floating_point:
            assert ttol.get_relative_tolerance(td) == pytest.approx(
                jtol.get_relative_tolerance(jd), rel=1e-12)
    with pytest.raises(TypeError):
        ttol.get_zero_tolerance(torch.bool)


def test_aabbs_obbs_and_bounding_radii(data):
    j, t = _sides(data)
    jpr, tpr = _prims(jp, j), _prims(tp, t)
    _close(tp.spherocylinder_endpoints(tpr["spherocylinder"]),
           jp.spherocylinder_endpoints(jpr["spherocylinder"]))
    _close(ta.compute_aabb_point(t["p"]), ja.compute_aabb_point(j["p"]))
    for name, kind in (("sphere", "sphere"), ("segment", "segment"),
                       ("scsegment", "scsegment"), ("spherocylinder", "spherocylinder"),
                       ("ellipsoid", "ellipsoid")):
        _close(getattr(ta, f"compute_aabb_{kind}")(tpr[name]),
               getattr(ja, f"compute_aabb_{kind}")(jpr[name]))
    for kind in ("sphere", "spherocylinder", "ellipsoid"):
        _close(getattr(ta, f"compute_bounding_radius_{kind}")(tpr[kind]),
               getattr(ja, f"compute_bounding_radius_{kind}")(jpr[kind]))
        _close(getattr(ta, f"compute_obb_{kind}")(tpr[kind]),
               getattr(ja, f"compute_obb_{kind}")(jpr[kind]))
    _close(ta.aabb_union(tpr["aabb"], ta.compute_aabb_sphere(tpr["sphere"])),
           ja.aabb_union(jpr["aabb"], ja.compute_aabb_sphere(jpr["sphere"])))
    _close(ta.aabb_inflate(tpr["aabb"], 0.3), ja.aabb_inflate(jpr["aabb"], 0.3))
    _close(ta.aabb_inflate(tpr["aabb"], t["r"]), ja.aabb_inflate(jpr["aabb"], j["r"]))


@pytest.mark.parametrize("name", ["aabb", "circle", "ellipsoid", "line", "plane", "ring",
                                  "scsegment", "segment", "sphere", "spherocylinder",
                                  "vsegment", "points"])
def test_transform_primitive(data, name):
    """Forward and inverse rigid transforms of every primitive (an AABB to
    the AABB of its rotated corners) by per-body (q, t); for points the
    inverse of the forward restores the input."""
    j, t = _sides(data)
    jo = j["p"] if name == "points" else _prims(jp, j)[name]
    to = t["p"] if name == "points" else _prims(tp, t)[name]
    args_j, args_t = (j["q2"], j["p2"]), (t["q2"], t["p2"])
    fwd = tt.transform_primitive(*args_t, to)
    _close(fwd, jt.transform_primitive(*args_j, jo))
    back = tt.inverse_transform_primitive(*args_t, fwd)
    _close(back, jt.inverse_transform_primitive(*args_j, jt.transform_primitive(*args_j, jo)))
    if name == "points":
        _close(back, to)
    _close(tt.inverse_transform_points(*args_t, tt.transform_points(*args_t, t["p"])), t["p"])
    with pytest.raises(TypeError):
        tt.transform_primitive(*args_t, "not a primitive")


@pytest.mark.parametrize("masked", [False, True])
def test_ball_joints(masked):
    rng = np.random.default_rng(4)
    n, J = 30, 50
    pos, quat = rng.uniform(0, 5, (n, 3)), _unit(rng, n, 4)
    a, b = rng.integers(0, n, J), rng.integers(0, n, J)
    oa, ob = rng.normal(size=(J, 3)), rng.normal(size=(J, 3))
    k = rng.uniform(10, 100, J)
    mask = rng.uniform(size=J) < 0.7 if masked else None
    ref = jj.ball_joint_forces(*(jnp.asarray(x) for x in (pos, quat, a, b, oa, ob, k)),
                               mask=None if mask is None else jnp.asarray(mask))
    got = tj.ball_joint_forces(*(torch.from_numpy(x) for x in (pos, quat, a, b, oa, ob, k)),
                               mask=None if mask is None else torch.from_numpy(mask))
    _close(got, ref, 1e-10)
    np.testing.assert_allclose(got[0].sum(0).numpy(), 0.0, atol=1e-9)  # action = reaction


@pytest.mark.parametrize("masked", [False, True])
def test_fieldops(masked):
    rng = np.random.default_rng(6)
    x, y = rng.normal(size=(64, 3)), rng.normal(size=(64, 3))
    m = rng.uniform(size=64) < 0.5 if masked else None
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    _close(tf.field_fill(tx, 2.5, tm), jf.field_fill(jx, 2.5, jm))
    _close(tf.field_copy(tx, ty, tm), jf.field_copy(jx, jy, jm))
    _close(tf.field_scale(tx, 1.5, tm), jf.field_scale(jx, 1.5, jm))
    _close(tf.field_axpy(0.5, tx, ty, tm), jf.field_axpy(0.5, jx, jy, jm))
    _close(tf.field_axpby(0.5, tx, -2.0, ty, tm), jf.field_axpby(0.5, jx, -2.0, jy, jm))
    _close(tf.field_product(tx, ty, tm), jf.field_product(jx, jy, jm))
    for fn in ("field_nrm2", "field_asum", "field_amax", "field_amin"):
        _close(getattr(tf, fn)(tx, tm), getattr(jf, fn)(jx, jm))
    _close(tf.field_dot(tx, ty, tm), jf.field_dot(jx, jy, jm))
    # a group in the axis_names slot reduces over ranks: parity with the
    # reference's psum in tests/test_torch_sharded_balanced.py
    r = tf.field_randomize(torch.Generator().manual_seed(0), tx, -1.0, 3.0, tm)
    sel = np.ones(64, bool) if m is None else m
    assert ((r.numpy()[sel] >= -1.0) & (r.numpy()[sel] < 3.0)).all()
    np.testing.assert_array_equal(r.numpy()[~sel], x[~sel])


def test_randomize_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    n, lo, hi = 2000, [0.0, -1.0, 2.0], [1.0, 1.0, 5.0]
    p = tr.random_points_in_box(gen, n, lo, hi, dtype=torch.float64)
    assert p.shape == (n, 3) and (p >= torch.tensor(lo)).all() and (p < torch.tensor(hi)).all()
    q = tr.random_unit_quaternions(gen, n, dtype=torch.float64)
    np.testing.assert_allclose(q.norm(dim=1).numpy(), 1.0, atol=1e-12)
    assert abs(float(q.mean())) < 0.05  # Haar: no preferred direction
    s = tr.random_spheres(gen, n, lo, hi, radius=(0.2, 0.5))
    assert s.radius.shape == (n,) and 0.2 <= float(s.radius.min()) < float(s.radius.max()) < 0.5
    sc = tr.random_spherocylinders(gen, n, lo, hi, radius=0.3, length=(1.0, 2.0))
    assert (sc.radius == 0.3).all() and float(sc.length.min()) >= 1.0
    seg = tr.random_segments(gen, n, lo, hi, length=(0.5, 1.0), dtype=torch.float64)
    ln = (seg.end - seg.start).norm(dim=1)
    assert float(ln.min()) >= 0.5 - 1e-12 and float(ln.max()) <= 1.0 + 1e-12
    e = tr.random_ellipsoids(gen, n, lo, hi, radii=((0.5, 1.0), 0.7, (0.1, 0.2)))
    assert e.radii.shape == (n, 3) and (e.radii[:, 1] == 0.7).all()
    assert float(e.radii[:, 2].max()) < 0.2 and float(e.radii[:, 0].min()) >= 0.5
    ring = tr.random_rings(gen, n, lo, hi, major_radius=(1.0, 2.0), minor_radius=0.1)
    assert ring.orientation.shape == (n, 4) and (ring.minor_radius == 0.1).all()
