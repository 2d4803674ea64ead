"""Package rules of the torch port: no JAX anywhere, no silent fallback.

The import scan reads the sources (AST), not sys.modules, because the
interpreter may preload JAX on its own.
"""

import ast
import pathlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.driver.apps.rods import RodsConfig, RodsSim
from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu_torch.ops.kernels import _build
from mundy_tpu_torch.ops.kernels import row_central as k1
from mundy_tpu_torch.ops.kernels import row_extract as k2
from mundy_tpu_torch.ops.kernels import row_hertz as k6
from mundy_tpu_torch.ops.kernels import row_segments as k4
from mundy_tpu_torch.ops.kernels import se_grid as k5
from mundy_tpu_torch.ops.kernels import seg_onehot as k3
from mundy_tpu_torch.parallel.comm import Group

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mundy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "mundy_tpu"), f"{path} imports {mod}"


def test_cuda_sim_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RowSpheresSim(SpheresConfig(num_spheres=100, box_size=16.0), device="cuda")


def test_k1_cuda_tensor_without_library_raises(monkeypatch, tmp_path):
    """A CUDA tensor never takes the plain version: with no library and no
    compiler the wrapper raises (a fake CUDA tensor stands in for a card)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k1, "row_hertzian_forces_plain", no_plain)
    before = k1.row_hertzian_forces_sym.launches
    with FakeTensorMode():
        pos = torch.zeros((8, 8, 16, 3), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k1.row_hertzian_forces_sym(pos, (12.0,) * 3, 0.5, 1000.0, 0.3)
    assert k1.row_hertzian_forces_sym.launches == before
    _build.load.cache_clear()


def test_k1_library_is_keyed_by_source():
    lib = _build.library_path("row_central")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("row_central_") and lib.suffix == ".so"


def test_entry_points_default_to_the_card():
    """A user who omits `device` runs on the card or gets an error, never a
    silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RowSpheresSim(SpheresConfig(num_spheres=100, box_size=16.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        LCPSpheresSim(LCPSpheresConfig(num_spheres=100, box_size=16.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        RowRodsSim(RodsConfig(num_rods=100, box_size=24.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        RodsSim(RodsConfig(num_rods=100, box_size=24.0, engine="nmat"))
    with pytest.raises(RuntimeError, match="CUDA"):
        FilamentsSim(FilamentsConfig(num_filaments=8, nodes_per_filament=5, box_size=24.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ChromatinSim(ChromatinConfig(num_chains=2, beads_per_chain=16, num_crosslinkers=4))


def _no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()


def test_k2_k3_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """As for K1: a CUDA tensor never takes the plain version."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k2, "row_neighbor_extract_plain", no_plain)
    monkeypatch.setattr(k3, "strided_segment_sum_plain", no_plain)
    before = (k2.row_neighbor_extract.launches, k3.strided_onehot_segment_sum.launches)
    with FakeTensorMode():
        pos = torch.zeros((8, 8, 16, 3), device="cuda")
        gid = torch.zeros((8, 8, 16), dtype=torch.int32, device="cuda")
        valid = torch.zeros((8, 8, 16), dtype=torch.bool, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k2.row_neighbor_extract(pos, gid, valid, ((12.0,) * 3, (True,) * 3), 1.45, 12, 500)
        values = torch.zeros((2, 3, 64), device="cuda")
        loc = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k3.strided_onehot_segment_sum(values, loc, 128)
    assert (k2.row_neighbor_extract.launches,
            k3.strided_onehot_segment_sum.launches) == before
    _build.load.cache_clear()


def test_k2_refuses_cpu_only_branches_on_cuda_tensors():
    """Open axes and K past the kernel's list run only in the plain version;
    on a CUDA tensor the wrapper raises before any build."""
    with FakeTensorMode():
        pos = torch.zeros((8, 8, 16, 3), device="cuda")
        gid = torch.zeros((8, 8, 16), dtype=torch.int32, device="cuda")
        valid = torch.zeros((8, 8, 16), dtype=torch.bool, device="cuda")
        box = ((12.0,) * 3, (True,) * 3)
        with pytest.raises(NotImplementedError, match="periodic"):
            k2.row_neighbor_extract(pos, gid, valid, ((12.0,) * 3, (True, True, False)),
                                    1.45, 12, 500)
        with pytest.raises(ValueError, match="at most"):
            k2.row_neighbor_extract(pos, gid, valid, box, 1.45, k2.K_MAX + 1, 500)


def test_k2_launch_envelope():
    """One envelope for the wrapper and rows_extract_feasible: K past the
    kernel's list fails before the card is asked, and a block within the
    48 KB that every block gets needs no opt-in query."""
    # packed x, y, z and 16-bit slots of 9 rows, float x bounds of each
    # chunk of 8, 9 counts and 9 row indices
    assert k2.shared_bytes(16, 4) == 9 * 16 * (3 * 4 + 2) + 9 * 2 * 2 * 4 + 18 * 4
    assert not k2.fits(16, k2.K_MAX + 1, 4, "cuda")
    assert k2.fits(16, k2.K_MAX, 4, "cuda")
    assert k2.fits(64, 26, 8, "cuda")  # 9 * 64 * 26 + 9 * 8 * 16 + 72 = 16,200 bytes


@pytest.mark.parametrize("name", ["row_extract", "seg_onehot"])
def test_k2_k3_libraries_are_keyed_by_source(name):
    lib = _build.library_path(name)
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith(f"{name}_") and lib.suffix == ".so"
    assert (_build.CSRC / f"{name}.cu").exists()


def test_k4_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """As for K1: a CUDA tensor never takes the plain version."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k4, "row_segment_pairs_plain", no_plain)
    before = k4.row_segment_pairs_sym.launches
    with FakeTensorMode():
        mid = torch.zeros((8, 8, 16, 3), device="cuda")
        valid = torch.ones((8, 8, 16), dtype=torch.bool, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k4.row_segment_pairs_sym(mid, torch.zeros_like(mid), valid, (24.0,) * 3, 0.25,
                                     500.0)
        with pytest.raises(ValueError, match="contiguous"):
            k4.row_segment_pairs_sym(mid, mid.transpose(0, 1), valid, (24.0,) * 3, 0.25,
                                     500.0)
        with pytest.raises(ValueError, match="contiguous"):
            k4.row_segment_pairs_sym(mid, mid, valid.transpose(0, 1), (24.0,) * 3, 0.25,
                                     500.0)
    assert k4.row_segment_pairs_sym.launches == before
    _build.load.cache_clear()


def test_k4_library_is_keyed_by_source_and_flags(monkeypatch):
    """Every kernel, K4 included, builds with -fmad=false; the flags are part
    of each library's key, so a library built with other flags is not
    loaded."""
    lib = _build.library_path("row_segments")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("row_segments_") and lib.suffix == ".so"
    assert "-fmad=false" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        tuple(f for f in _build.NVCC_FLAGS if f != "-fmad=false"))
    assert _build.library_path("row_segments") != lib


def test_k4_filaments_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """As for the rods op: a CUDA tensor never takes the plain version, and
    a non-contiguous or mistyped gid raises before any build."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k4, "row_segment_filaments_plain", no_plain)
    before = k4.row_segment_filaments_sym.launches
    with FakeTensorMode():
        mid = torch.zeros((8, 8, 16, 3), device="cuda")
        valid = torch.ones((8, 8, 16), dtype=torch.bool, device="cuda")
        gid = torch.zeros((8, 8, 16), dtype=torch.int32, device="cuda")
        args = ((24.0,) * 3, 0.25, 500.0, 7)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k4.row_segment_filaments_sym(mid, torch.zeros_like(mid), valid, gid, *args)
        with pytest.raises(ValueError, match="contiguous"):
            k4.row_segment_filaments_sym(mid, mid, valid, gid.transpose(0, 1), *args)
        with pytest.raises(ValueError, match="int32"):
            k4.row_segment_filaments_sym(mid, mid, valid, gid.long(), *args)
    assert k4.row_segment_filaments_sym.launches == before
    _build.load.cache_clear()


def test_new_modules_import_without_jax():
    """The filaments slice's modules: rod mechanics, the segment distance
    and the app, importable and free of JAX (scanned above)."""
    import importlib

    for name in ("mundy_tpu_torch.mech", "mundy_tpu_torch.mech.rod",
                 "mundy_tpu_torch.geom.distance", "mundy_tpu_torch.driver.apps.filaments"):
        mod = importlib.import_module(name)
        path = pathlib.Path(mod.__file__)
        assert path in PORT_FILES


def _se_fake_inputs(geom, n=64):
    n_tiles = (geom.G // geom.m) ** 3
    perm = torch.zeros((n_tiles, geom.R), dtype=torch.int32, device="cuda")
    u = torch.zeros((n_tiles, geom.R, 3), device="cuda")
    pieces = (perm, torch.zeros((), dtype=torch.bool, device="cuda"), u,
              torch.zeros((n_tiles, geom.R), dtype=torch.bool, device="cuda"),
              torch.zeros((n,), dtype=torch.int32, device="cuda"))
    return pieces, torch.zeros((n, 3), device="cuda")


def test_k5_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """As for K1: a CUDA tensor never takes K5s's or K5i's plain version;
    without a library and a compiler the wrappers raise, and a tile edge
    below P/2 + 1 raises before any build."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k5, "se_spread_plain", no_plain)
    monkeypatch.setattr(k5, "se_interp_plain", no_plain)
    geom = k5.make_se_grid_tiles(32, 6, 12.0, 0.87, 0.0, 64, kind="es", beta=12.2)
    before = (k5.se_spread.launches, k5.se_interp.launches)
    with FakeTensorMode():
        pieces, forces = _se_fake_inputs(geom)
        # K5i's layout: three planes, the channel axis outermost
        grid = torch.zeros((3, 32, 32, 32), device="cuda").permute(1, 2, 3, 0)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k5.se_spread(geom, pieces, forces)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k5.se_interp(geom, pieces, grid)
        with pytest.raises(ValueError, match="tile edge"):
            k5.se_spread(geom._replace(P=16), pieces, forces)
        with pytest.raises(ValueError, match="contiguous"):
            k5.se_spread(geom, pieces, torch.zeros((3, 64), device="cuda").t())
    assert (k5.se_spread.launches, k5.se_interp.launches) == before
    _build.load.cache_clear()


def test_k5_rows_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """K5s-rows and K5i-rows: a CUDA tensor never takes the plain version;
    without a library and a compiler the wrappers raise, and geometries
    outside the kernels' envelope raise before any build."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k5, "se_spread_rows_plain", no_plain)
    monkeypatch.setattr(k5, "se_interp_rows_plain", no_plain)
    geom = k5.make_se_grid_rows(32, 6, 12.0, 0.87, 0.0, 64, kind="es", beta=12.2)
    before = (k5.se_spread_rows_pre.launches, k5.se_interp_rows_pre.launches)
    with FakeTensorMode():
        rows, R, W = 16, geom.R, geom.m + geom.P
        ids = torch.zeros((rows, R), dtype=torch.int32, device="cuda")
        pieces = (ids, torch.zeros((), dtype=torch.bool, device="cuda"), ids, ids,
                  torch.zeros((rows, R, 6), device="cuda"),
                  torch.zeros((rows, R, 6), device="cuda"),
                  torch.zeros((rows, R, W), device="cuda"))
        forces = torch.zeros((64, 3), device="cuda")
        grid = torch.zeros((3, 32, 32, 32), device="cuda").permute(1, 2, 3, 0)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k5.se_spread_rows_pre(geom, pieces, forces)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k5.se_interp_rows_pre(geom, pieces, 64, grid)
        with pytest.raises(ValueError, match="strides"):
            k5.se_interp_rows_pre(geom, pieces, 64, torch.zeros((32, 32, 32, 3), device="cuda"))
        wide = k5.make_se_grid_rows(32, 20, 12.0, 0.87, 0.0, 64, kind="es", beta=12.2)
        wpieces = pieces[:4] + (torch.zeros((rows, R, 20), device="cuda"),) * 2 + (
            torch.zeros((rows, R, 28), device="cuda"),)
        with pytest.raises(ValueError, match="row edge|support"):
            k5.se_spread_rows_pre(wide, wpieces, forces)
        with pytest.raises(TypeError, match="int32"):
            k5.se_spread_rows_pre(geom, (ids.long(),) + pieces[1:], forces)
    assert (k5.se_spread_rows_pre.launches, k5.se_interp_rows_pre.launches) == before
    _build.load.cache_clear()


def test_sorted_blocked_segment_sum_takes_k3(monkeypatch):
    """segment_sum_sorted_blocked reduces through K3's wrapper (which on a
    CUDA tensor launches the kernel or raises, as tested above), three
    value columns a call."""
    from mundy_tpu_torch.ops import segments

    calls = []
    real = segments.strided_onehot_segment_sum

    def spy(values, loc, B):
        calls.append(tuple(values.shape))
        return real(values, loc, B)

    monkeypatch.setattr(segments, "strided_onehot_segment_sum", spy)
    ids = torch.arange(200, dtype=torch.int32) // 2
    win = segments.segment_windows(ids, 100, 64, 160)
    out = segments.segment_sum_sorted_blocked(torch.ones((200, 5), dtype=torch.float64), ids,
                                              100, win)
    assert calls == [(2, 3, 160), (2, 3, 160)]
    assert torch.equal(out, torch.full((100, 5), 2.0, dtype=torch.float64))


def test_k5_library_is_keyed_by_source():
    lib = _build.library_path("se_grid")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("se_grid_") and lib.suffix == ".so"
    assert (_build.CSRC / "se_grid.cu").exists()


def test_scatter_gridding_refuses_cuda_tensors():
    """The spectral scatter gridding (index_add_ and a gather) is the CPU's:
    a CUDA tensor raises, naming the tile gridding, before any grid work
    (freespace_wave_apply and se_rpy_apply reach the same two functions)."""
    from mundy_tpu_torch.mobility import spectral as tsp

    op = tsp.build_spectral_ewald(12.0, 0.5, 1.0, tol=1e-4, window="es")
    with FakeTensorMode():
        pos = torch.zeros((8, 3), device="cuda")
        grid = torch.zeros((op.grid_n,) * 3 + (3,), device="cuda")
        for call in (lambda: tsp.se_spread(op, pos, pos), lambda: tsp.se_interpolate(op, pos, grid),
                     lambda: tsp.se_wave_apply(op, pos, pos)):
            with pytest.raises(RuntimeError, match="tile gridding"):
                call()


@pytest.mark.parametrize("hydro", ["rpy_periphery", "rpy_periphery_spectral"])
def test_chromatin_unported_modes_raise(hydro):
    """The periphery BIE modes are ported: each constructs and steps on the
    CPU when asked (the card is the default), within its periphery. The
    sharded mode (mesh=, tests/test_torch_spectral_shard.py) refuses a mesh
    that is not a parallel.comm.Group and N % ranks != 0, never runs
    something else."""
    cfg = ChromatinConfig(num_chains=2, beads_per_chain=16, num_crosslinkers=4,
                          hydro=hydro, periphery_radius=8.0, periphery_order=6,
                          dtype="float64")
    sim = ChromatinSim(cfg, device="cpu")
    assert (sim.freespace is not None) == (hydro == "rpy_periphery_spectral")
    st = sim.run_block(sim.init(), 2)
    assert st.step == 2 and not bool(st.overflow)
    assert bool(torch.isfinite(st.pos).all()) and float(st.pos.norm(dim=1).max()) < 8.0
    spectral = ChromatinConfig(num_chains=2, beads_per_chain=16, hydro="rpy_spectral",
                               box_size=16.0)
    with pytest.raises(TypeError, match="mesh= takes a parallel.comm.Group"):
        ChromatinSim(spectral, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="N % ranks == 0"):
        ChromatinSim(spectral, device="cpu", mesh=Group(0, 3, "cpu", "gloo"))


def test_chromatin_slice_modules_import_without_jax():
    """The chromatin slice's modules, importable and free of JAX (scanned
    above)."""
    import importlib

    for name in ("mundy_tpu_torch.math.spacefill", "mundy_tpu_torch.state.world",
                 "mundy_tpu_torch.state.select", "mundy_tpu_torch.kmc.crosslinkers",
                 "mundy_tpu_torch.forces.springs", "mundy_tpu_torch.forces.contact",
                 "mundy_tpu_torch.mobility.rpy", "mundy_tpu_torch.mobility.ewald",
                 "mundy_tpu_torch.mobility.spectral", "mundy_tpu_torch.mobility.periphery",
                 "mundy_tpu_torch.mobility.freespace", "mundy_tpu_torch.mobility",
                 "mundy_tpu_torch.neighbor.cells3d",
                 "mundy_tpu_torch.ops.kernels.se_grid",
                 "mundy_tpu_torch.driver.apps.chromatin"):
        mod = importlib.import_module(name)
        assert pathlib.Path(mod.__file__) in PORT_FILES


def test_polydisperse_sims_default_to_the_card():
    """The polydisperse branches, like the others, run on the card or raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RowSpheresSim(SpheresConfig(num_spheres=100, box_size=16.0, polydispersity=0.4))
    with pytest.raises(RuntimeError, match="CUDA"):
        LCPSpheresSim(LCPSpheresConfig(num_spheres=100, box_size=16.0, polydispersity=0.5),
                      device="cuda")


def test_k3t_k6_k2_radii_cuda_tensors_without_library_raise(monkeypatch, tmp_path):
    """As for K1: a CUDA tensor never takes K3t's, K6's (with or without a
    radius plane) or K2's radius variant's plain version; without a library
    and a compiler the wrappers raise, and a non-contiguous input raises
    before any build."""
    _no_library(monkeypatch, tmp_path)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(k3, "strided_t_plain", no_plain)
    monkeypatch.setattr(k6, "row_hertzian_forces_plain", no_plain)
    monkeypatch.setattr(k2, "row_neighbor_extract_plain", no_plain)
    before = (k3.strided_onehot_t.launches, k6.row_hertzian_forces.launches,
              k2.row_neighbor_extract.radius_launches)
    with FakeTensorMode():
        gamma = torch.zeros((2, 64), device="cuda")
        normals = torch.zeros((2, 3, 64), device="cuda")
        loc = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k3.strided_onehot_t(gamma, normals, loc, 128)
        with pytest.raises(TypeError, match="int32"):
            k3.strided_onehot_t(gamma, normals, loc.long(), 128)
        pos = torch.zeros((8, 8, 16, 3), device="cuda")
        valid = torch.zeros((8, 8, 16), dtype=torch.bool, device="cuda")
        radii = torch.zeros((8, 8, 16), device="cuda")
        for r in (None, radii):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                k6.row_hertzian_forces(pos, valid, (12.0,) * 3, 0.5, 1000.0, 0.3, radii=r)
        with pytest.raises(ValueError, match="contiguous"):
            k6.row_hertzian_forces(pos, valid, (12.0,) * 3, 0.5, 1000.0, 0.3,
                                   radii=radii.transpose(0, 1))
        gid = torch.zeros((8, 8, 16), dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            k2.row_neighbor_extract(pos, gid, valid, ((12.0,) * 3, (True,) * 3), 1.45, 12,
                                    500, radii=radii)
    assert (k3.strided_onehot_t.launches, k6.row_hertzian_forces.launches,
            k2.row_neighbor_extract.radius_launches) == before
    _build.load.cache_clear()


def test_k6_k2_radius_envelopes():
    """The shared memory that K6 (the packed x, y, z, radius entries of 9
    rows, chunk bounds per 8 of them, own slots and counts) and K2's radius
    variant (its planes with the radii, and each chunk's greatest |radius|)
    stage: within the 48 KB every block gets, no card is asked."""
    assert k6.shared_bytes(96, 4) == (36 * 96 + 36 * 12) * 4 + 4 * 96 + 36
    assert k6.fits(256, 4, "cuda")  # 42,532 bytes
    assert k2.shared_bytes(96, 4, radii=True) == 9 * 96 * (4 * 4 + 2) + 9 * 12 * 3 * 4 + 18 * 4
    assert k2.fits(64, 26, 8, "cuda", radii=True)  # 9 * 64 * 34 + 9 * 8 * 12 + 72 = 20,520


def test_k6_library_is_keyed_by_source():
    lib = _build.library_path("row_hertz")
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib.name.startswith("row_hertz_") and lib.suffix == ".so"
    assert (_build.CSRC / "row_hertz.cu").exists()


def test_cli_slice_modules_import_without_jax():
    """The CLI slice's modules: the pair list, the flat spheres engine,
    friction, granular, the IO package and the driver, importable and free
    of JAX (scanned above)."""
    import importlib

    for name in ("mundy_tpu_torch.neighbor", "mundy_tpu_torch.neighbor.cell_list",
                 "mundy_tpu_torch.driver.apps.spheres", "mundy_tpu_torch.forces.friction",
                 "mundy_tpu_torch.driver.apps.granular", "mundy_tpu_torch.io",
                 "mundy_tpu_torch.io.native", "mundy_tpu_torch.io.trajectory",
                 "mundy_tpu_torch.io.vtk", "mundy_tpu_torch.io.checkpoint",
                 "mundy_tpu_torch.io.telemetry", "mundy_tpu_torch.io.broker",
                 "mundy_tpu_torch.driver.configurator", "mundy_tpu_torch.driver.main"):
        mod = importlib.import_module(name)
        assert pathlib.Path(mod.__file__) in PORT_FILES


def test_cli_entry_points_default_to_the_card():
    """The flat spheres engine and the granular app, like the others, run on
    the card or raise; the configurator passes the device through."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
    from mundy_tpu_torch.driver.apps.spheres import SpheresSim
    from mundy_tpu_torch.driver.configurator import build_simulation

    with pytest.raises(RuntimeError, match="CUDA"):
        SpheresSim(SpheresConfig(num_spheres=100, box_size=16.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        GranularSim(GranularConfig(num_spheres=100, box_size=10.0))
    for app in ("spheres", "granular", "lcp_spheres"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_simulation({"app": app, "params": {"num_spheres": 100, "box_size": 16.0}})


def test_rods_slice_modules_import_without_jax():
    """The (N, K) rods slice's modules: the distance family and its
    primitives, L-BFGS, the JAX-stream Brownian draws, the segment friction,
    RodsSim and the small modules, importable and free of JAX (scanned
    above)."""
    import importlib

    for name in ("mundy_tpu_torch.math.linalg", "mundy_tpu_torch.math.quaternion",
                 "mundy_tpu_torch.math.lbfgs", "mundy_tpu_torch.math.tolerance",
                 "mundy_tpu_torch.geom.primitives", "mundy_tpu_torch.geom.distance",
                 "mundy_tpu_torch.geom.aabb", "mundy_tpu_torch.geom.transform",
                 "mundy_tpu_torch.geom.randomize", "mundy_tpu_torch.mech.joints",
                 "mundy_tpu_torch.state.fieldops", "mundy_tpu_torch.dynamics.brownian",
                 "mundy_tpu_torch.forces.friction", "mundy_tpu_torch.driver.apps.rods"):
        mod = importlib.import_module(name)
        assert pathlib.Path(mod.__file__) in PORT_FILES
