"""Blocked segmented sums: K3's plain version and ops/segments.py vs the JAX
reference, on the CPU.

Tolerances: the reference's f32 path sums through a three-term bf16 split
of each value (about 1-2 ulp per summand) and the port sums in f32 directly,
so float32 agrees within 4 ulp of the segment's sum of |values|; float64
within 1e-12 of it (summation order only). Integer outputs are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mundy_tpu.ops import segments as jseg
from mundy_tpu.ops.pallas.seg_onehot import strided_onehot_segment_sum as pallas_sum
from mundy_tpu_torch.ops import segments as tseg
from mundy_tpu_torch.ops.kernels import seg_onehot as k3

torch.set_num_threads(1)
_NP = {"float32": np.float32, "float64": np.float64}


def _strided(nb, W, B, dtype, sort, seed=2):
    """(nb, 3, W) values and (nb, W) local ids, some outside [0, B)."""
    rng = np.random.default_rng(seed)
    loc = rng.integers(-B // 4, B + B // 4, (nb, W)).astype(np.int32)
    if sort:
        loc = np.sort(loc, axis=1)
    return rng.normal(size=(nb, 3, W)).astype(_NP[dtype]), loc


def _abs_sums(values, loc, B):
    """(nb, 3, B) per-segment sums of |values| in float64."""
    nb, _, W = values.shape
    out = np.zeros((nb, 3, B + 1))
    col = np.where((loc >= 0) & (loc < B), loc, B)
    for b in range(nb):
        for c in range(3):
            np.add.at(out[b, c], col[b], np.abs(values[b, c].astype(np.float64)))
    return out[..., :B]


def _assert_close(got, ref, values, loc, B, dtype):
    scale = _abs_sums(values, loc, B)
    tol = 4 * np.finfo(np.float32).eps if dtype == "float32" else 1e-12
    assert (np.abs(got.astype(np.float64) - ref) <= tol * scale).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nb,W,B,sort", [(3, 256, 128, True), (4, 520, 256, False)])
def test_k3_plain_matches_reference(dtype, nb, W, B, sort):
    """K3's plain version vs JAX segment_sum_strided on the CPU (the
    windowed one-hot reduction), with ids outside [0, B) and unsorted ids."""
    values, loc = _strided(nb, W, B, dtype, sort)
    ids = loc + (np.arange(nb, dtype=np.int32)[:, None] * B)
    win = jseg.StridedWindows(block_bodies=B, window=W, nb=nb, overflow=jnp.asarray(False))
    ref = jseg.segment_sum_strided(jnp.asarray(values.transpose(0, 2, 1).reshape(-1, 3)),
                                   jnp.asarray(ids.reshape(-1)), nb * B, win)
    ref = np.asarray(ref, np.float64).reshape(nb, B, 3).transpose(0, 2, 1)
    got = k3.strided_onehot_segment_sum(torch.from_numpy(values), torch.from_numpy(loc), B)
    assert got.shape == (nb, 3, B) and got.dtype == torch.from_numpy(values).dtype
    _assert_close(got.numpy(), ref, values, loc, B, dtype)


@pytest.mark.parametrize("sort", [True, False])
def test_k3_plain_matches_pallas_kernel(sort):
    """K3's plain version vs the TPU kernel in interpret mode (float32)."""
    nb, W, B = 3, 256, 128
    values, loc = _strided(nb, W, B, "float32", sort, seed=7)
    ref = np.asarray(pallas_sum(jnp.asarray(values), jnp.asarray(loc), B,
                                interpret=True), np.float64)
    got = k3.strided_segment_sum_plain(torch.from_numpy(values), torch.from_numpy(loc), B)
    _assert_close(got.numpy(), ref, values, loc, B, "float32")


def test_k3_plain_sums_in_slot_order():
    """Each segment is summed over its slots in increasing w from zero: the
    order the CUDA kernel adds in, so the two can agree bit for bit."""
    values, loc = _strided(2, 300, 64, "float32", False, seed=5)
    got = k3.strided_segment_sum_plain(torch.from_numpy(values), torch.from_numpy(loc), 64)
    want = np.zeros((2, 3, 64), np.float32)
    for b in range(2):
        for w in range(300):
            if 0 <= loc[b, w] < 64:
                want[b, :, loc[b, w]] += values[b, :, w]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_starts", [True, False])
def test_segment_windows_match_reference(use_starts):
    rng = np.random.default_rng(4)
    n, B, W = 2500, 1024, 4096
    counts = rng.integers(0, 5, n)
    ids = np.concatenate([np.repeat(np.arange(n), counts), np.full(300, n)]).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    kw = dict(body_starts=starts) if use_starts else {}
    ref = jseg.segment_windows(jnp.asarray(ids), n, B, W,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tseg.segment_windows(torch.from_numpy(ids), n, B, W,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(ref.starts))
    assert bool(got.overflow) == bool(ref.overflow) is False
    small = tseg.segment_windows(torch.from_numpy(ids), n, B, 1024)
    assert bool(small.overflow) == bool(jseg.segment_windows(jnp.asarray(ids), n, B, 1024).overflow)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_sums_match_reference(dtype):
    """segment_sum_strided (through K3) vs the reference's windowed
    segment_sum_sorted_blocked on one sorted id list with a pad tail, laid
    out in the strided layout: block b's rows at [b*W, b*W + count_b)."""
    rng = np.random.default_rng(6)
    n, B = 1500, 512
    counts = rng.integers(0, 4, n)
    ids = np.concatenate([np.repeat(np.arange(n), counts), np.full(100, n)]).astype(np.int32)
    values = rng.normal(size=(ids.shape[0], 3)).astype(_NP[dtype])
    values[ids == n] = 0.0
    jwin = jseg.segment_windows(jnp.asarray(ids), n, B, 2048)
    ref = np.asarray(jseg.segment_sum_sorted_blocked(jnp.asarray(values), jnp.asarray(ids),
                                                     n, jwin), np.float64)
    scale = np.zeros((n + 1, 3))
    np.add.at(scale, ids, np.abs(values.astype(np.float64)))
    tol = 4 * np.finfo(np.float32).eps if dtype == "float32" else 1e-12
    nb, W = -(-n // B), 2048
    sv = np.zeros((nb * W, 3), _NP[dtype])
    si = np.full(nb * W, n, np.int32)
    for b in range(nb):
        rows = np.nonzero((ids >= b * B) & (ids < min((b + 1) * B, n)))[0]
        sv[b * W:b * W + rows.size] = values[rows]
        si[b * W:b * W + rows.size] = ids[rows]
    swin = tseg.StridedWindows(block_bodies=B, window=W, nb=nb,
                               overflow=torch.tensor(False))
    got_s = tseg.segment_sum_strided(torch.from_numpy(sv), torch.from_numpy(si), n, swin)
    assert (np.abs(got_s.numpy() - ref) <= tol * scale[:n]).all()


@pytest.mark.parametrize("line", [
    dict(num_spheres=2000, box_size=20.0, polydispersity=0.0),
    dict(num_spheres=400, box_size=18.0, polydispersity=0.5),
])
def test_lcp_strided_loc_is_nondecreasing_in_every_block(monkeypatch, line):
    """The premise of K3's fast path (csrc/seg_onehot.cu): the strided
    layout that LCPSpheresSim hands K3 at every step, rebuild included, has
    a nondecreasing loc in every block, the pad slots (id N) last. Both the
    monodisperse and the polydisperse line, recorded at K3's wrapper; the
    monodisperse line's 2 blocks put N inside the last block's id range."""
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.ops import segments

    seen = []
    real = segments.strided_onehot_segment_sum

    def spy(values, loc, B):
        seen.append((loc.clone(), B))
        return real(values, loc, B)

    monkeypatch.setattr(segments, "strided_onehot_segment_sum", spy)
    cfg = LCPSpheresConfig(radius=0.5, dt=1e-3, diffusion_coeff=0.01, constraint_buffer=0.45,
                           dtype="float64", **line)
    sim = LCPSpheresSim(cfg, device="cpu")
    st = sim.init()
    rb0, steps = st.rebuild_count, 8
    for _ in range(steps):
        st = sim.run_block(st, 1, resize=False)
    assert st.rebuild_count > rb0 and not bool(st.overflow)
    assert len(seen) >= steps
    n = line["num_spheres"]
    for loc, B in seen:
        assert bool((loc[:, 1:] >= loc[:, :-1]).all())
        pad = n - B * (loc.shape[0] - 1)  # the pads' id in the last block
        assert bool((loc[-1] == pad).any()) and bool((loc[-1, -1] == pad))
