"""The port's IO against the JAX package's: the native library, the MTRJ1
trajectories (native and numpy writers, byte for byte, each package
reading the other's), the CRC check, Hilbert keys, VTK/XYZ snapshots,
state checkpoints of the port's trees and the results broker."""

import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mundy_tpu.io.trajectory as jtraj
import mundy_tpu.io.vtk as jvtk
import mundy_tpu_torch.io.trajectory as ttraj
import mundy_tpu_torch.io.vtk as tvtk
from mundy_tpu.math.spacefill import hilbert_key_3d as jax_hilbert_key_3d
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim
from mundy_tpu_torch.io import latest_checkpoint, load_checkpoint, save_checkpoint
from mundy_tpu_torch.io import native
from mundy_tpu_torch.io.broker import ResultsBroker, positions_of
from mundy_tpu_torch.io.telemetry import StepLogger, trace
from mundy_tpu_torch.math.spacefill import hilbert_key_3d

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sha(path):
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def test_fastio_is_the_references_source():
    assert _sha(ROOT / "mundy_tpu_torch/io/native/fastio.cpp") == \
        _sha(ROOT / "mundy_tpu/io/native/fastio.cpp")


def test_native_library_builds_into_build_native():
    assert native.library() is not None  # g++ is on this machine
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert path.name == f"fastio_{_sha(native.SOURCE)[:16]}.so"


def _frames(rng, n=37, k=4):
    return [(10 * i, 0.5 * i, rng.normal(size=(n, 3))) for i in range(k)]


@pytest.fixture(params=["native", "numpy"])
def writer(request, monkeypatch):
    """Both packages on the native library, or both on their numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(jtraj, "library", lambda: None)
        monkeypatch.setattr(ttraj, "library", lambda: None)
    return request.param


def _write(mod, path, frames, append_from=None):
    n = frames[0][2].shape[0]
    first = frames if append_from is None else frames[:append_from]
    with mod.TrajectoryWriter(str(path), n) as w:
        for step, t, pos in first:
            w.write(step, t, pos)
    if append_from is not None:
        with mod.TrajectoryWriter(str(path), n, append=True) as w:
            for step, t, pos in frames[append_from:]:
                w.write(step, t, pos)


def test_trajectory_bytes_equal_the_references(writer, tmp_path, rng):
    frames = _frames(rng)
    _write(jtraj, tmp_path / "j.mtrj", frames)
    _write(ttraj, tmp_path / "t.mtrj", [(s, t, torch.from_numpy(p)) for s, t, p in frames],
           append_from=2)
    assert (tmp_path / "t.mtrj").read_bytes() == (tmp_path / "j.mtrj").read_bytes()


@pytest.mark.parametrize("direction", ["port_reads_reference", "reference_reads_port"])
def test_each_reader_reads_the_others_file(writer, direction, tmp_path, rng):
    frames = _frames(rng)
    w_mod, r_mod = (jtraj, ttraj) if direction == "port_reads_reference" else (ttraj, jtraj)
    _write(w_mod, tmp_path / "x.mtrj", frames)
    r = r_mod.TrajectoryReader(str(tmp_path / "x.mtrj"))
    assert (r.n, r.num_frames) == (37, 4)
    for i, (step, t, pos) in enumerate(frames):
        s, tt, p = r.read(i)
        assert (s, tt) == (step, t)
        np.testing.assert_array_equal(p, pos.astype(np.float32))
    r.close()


def test_crc_detects_corruption(writer, tmp_path, rng):
    path = tmp_path / "c.mtrj"
    _write(ttraj, path, _frames(rng, k=1))
    data = bytearray(path.read_bytes())
    data[-5] ^= 0xFF
    path.write_bytes(bytes(data))
    r = ttraj.TrajectoryReader(str(path))
    with pytest.raises(IOError, match="CRC"):
        r.read(0)


def test_writer_checks_the_frame_shape(tmp_path):
    with ttraj.TrajectoryWriter(str(tmp_path / "s.mtrj"), 5) as w:
        with pytest.raises(ValueError, match=r"\(5, 3\)"):
            w.write(0, 0.0, np.zeros((4, 3)))


def test_hilbert_keys_native_equal_spacefill(rng):
    pos = rng.uniform(0, 10, (500, 3))
    keys_c = ttraj.hilbert_keys_native(pos, [0, 0, 0], [10, 10, 10], bits=8)
    cells = np.clip((pos / 10 * 256).astype(np.int64), 0, 255)
    keys_p = hilbert_key_3d(cells[:, 0], cells[:, 1], cells[:, 2], bits=8)
    keys_j = np.asarray(jax_hilbert_key_3d(jnp.asarray(cells[:, 0]), jnp.asarray(cells[:, 1]),
                                           jnp.asarray(cells[:, 2]), bits=8))
    assert keys_c.dtype == keys_p.dtype == np.uint32
    np.testing.assert_array_equal(keys_c, keys_p)
    np.testing.assert_array_equal(keys_p, keys_j)
    with pytest.raises(ValueError, match="10 bits"):
        hilbert_key_3d(cells[:, 0], cells[:, 1], cells[:, 2], bits=11)


def test_vtk_and_xyz_bytes_equal_the_references(tmp_path, rng):
    pos = rng.normal(size=(23, 3))
    data = {"radius": rng.uniform(0.4, 0.6, 23), "vel": rng.normal(size=(23, 3))}
    jvtk.write_vtk_points(str(tmp_path / "j.vtk"), pos, point_data=data)
    tvtk.write_vtk_points(str(tmp_path / "t.vtk"), torch.from_numpy(pos),
                          point_data={k: torch.from_numpy(v) for k, v in data.items()})
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path / "j.vtk").read_bytes()
    for mod, name in ((jvtk, "j.xyz"), (tvtk, "t.xyz")):
        mod.write_xyz(str(tmp_path / name), pos, comment="frame 0")
        mod.write_xyz(str(tmp_path / name), pos[:5], append=True, comment="frame 1")
    assert (tmp_path / "t.xyz").read_bytes() == (tmp_path / "j.xyz").read_bytes()
    with pytest.raises(ValueError, match="unsupported shape"):
        tvtk.write_vtk_points(str(tmp_path / "bad.vtk"), pos, {"m": np.zeros((23, 2))})


def _spheres(**over):
    kw = dict(num_spheres=200, box_size=10.0, diffusion_coeff=0.05, dtype="float64")
    sim = SpheresSim(SpheresConfig(**dict(kw, **over)), device="cpu")
    return sim, sim.init()


def test_checkpoint_round_trip(tmp_path):
    sim, st = _spheres()
    st = sim.run_block(st, 7)
    path = save_checkpoint(str(tmp_path), st.step, st, metadata={"app": "spheres"})
    assert pathlib.Path(path).name == "ckpt_000000000007.npz"
    assert (tmp_path / "ckpt_000000000007.json").exists()
    template = sim.init()
    back = load_checkpoint(path, template)
    assert (back.step, back.rebuild_count, back.key) == (st.step, st.rebuild_count, st.key)
    assert isinstance(back.step, int) and isinstance(back.key, tuple)
    for name in ("pos", "ref_pos", "overflow"):
        assert torch.equal(getattr(back, name), getattr(st, name))
    assert torch.equal(back.nmat.idx, st.nmat.idx) and back.nmat.idx.dtype == torch.int32
    assert torch.equal(back.nmat.mask, st.nmat.mask)
    # the continued run equals the uninterrupted one bit for bit
    assert torch.equal(sim.run_block(back, 5).pos, sim.run_block(st, 5).pos)


def test_checkpoint_casts_to_the_templates_dtype(tmp_path):
    sim, st = _spheres()
    path = save_checkpoint(str(tmp_path), 0, st)
    sim32, template = _spheres(dtype="float32")
    back = load_checkpoint(path, template)
    assert back.pos.dtype == torch.float32
    assert torch.equal(back.pos, st.pos.to(torch.float32))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    sim, st = _spheres()
    path = save_checkpoint(str(tmp_path), 0, st)
    _, other = _spheres(num_spheres=150)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, other)


def test_checkpoint_name_keyed_fallback(tmp_path):
    """A checkpoint with an extra leaf still loads by field path."""
    sim, st = _spheres()
    path = save_checkpoint(str(tmp_path), 3, {"extra": torch.zeros(2), "s": st})
    back = load_checkpoint(path, {"s": sim.init()})
    assert torch.equal(back["s"].pos, st.pos)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, {"t": sim.init()})


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    sim, st = _spheres()
    for step in (2, 10, 9):
        save_checkpoint(str(tmp_path), step, st)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_000000000010.npz")


def test_results_broker_and_telemetry(tmp_path):
    sim, st = _spheres()
    with ResultsBroker(str(tmp_path), 0, every=2, dt=1e-4) as b:
        b.write_frame(0, sim, st)
        for step in range(1, 5):
            st = sim.run_block(st, 1)
            b.maybe_write(step, sim, st)
        vtk = b.finalize(4, sim, st)
    assert b.frames_written == 3 and pathlib.Path(vtk).name == "final.vtk"
    r = ttraj.TrajectoryReader(b.trajectory_path)
    assert r.num_frames == 3 and r.read(2)[:2] == (4, 4e-4)
    np.testing.assert_array_equal(r.read(2)[2], positions_of(sim, st).astype(np.float32))
    lines = []
    log = StepLogger(4, log_every=2, log=lines.append)
    for step in range(1, 5):
        with trace("step"):
            log.update(step, rebuilds=st.rebuild_count)
    stats = log.final_stats()
    assert len(lines) == 3 and lines[0].startswith("step 2/4") and stats["total_steps"] == 4
