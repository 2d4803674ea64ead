"""ShardedSim and `main --devices N` on the CPU (driver/sharded.py,
driver/main.py), and the backend rule of parallel/comm.py.

- `main config.yaml --devices 2 --device cpu` runs the flat spheres app's
  YAML over 2 gloo ranks end to end: rank 0 alone writes the trajectory
  frames, the final VTK and the checkpoint, whose positions are the
  single-device RowSpheresSim's over the same steps within 1e-7 (one
  process group for the file).
- The backend rule: gloo on the CPU, NCCL with a card per rank, gloo with
  staging when ranks share a card.
- `main --devices 2 --device cpu` runs the repo's lcp_spheres and granular
  example YAMLs (cut in size and steps) over the balanced engines: the plan
  line and the decomposition line once, rank 0 alone writes the final VTK
  and the checkpoint.
- ShardedSim refuses what its engines do not run; refuse_unported refuses,
  before any rank starts, the configs the engines cannot split and LCP
  rpy_ring over ranks (ROADMAP queue 1, item 8 step 4); spawn_ranks without
  a device raises here, where there is no card.
- regrow grows the slab engine's row capacity (ROADMAP queue 3): a
  capacity too small for a row overflows, main's loop regrows and retries,
  and the run ends where one with room to spare ends.
- A rank that raises fails the launch with its traceback; a rank that
  hangs is killed at the launcher's timeout, which raises.
"""

import time

import numpy as np
import pytest
import torch

import torch_rank_bodies as bodies

from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig
from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig
from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu_torch.driver.apps.rods import RodsConfig
from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
from mundy_tpu_torch.driver.apps.spheres import SpheresConfig
from mundy_tpu_torch.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu_torch.driver.main import main
from mundy_tpu_torch.driver.sharded import ShardedSim, refuse_unported
from mundy_tpu_torch.io import load_checkpoint
from mundy_tpu_torch.io.trajectory import TrajectoryReader
from mundy_tpu_torch.parallel.comm import Group, RankError, backend_plan, spawn_ranks

torch.set_num_threads(1)

PARAMS = dict(num_spheres=600, box_size=16.0, radius=0.5, youngs_modulus=200.0,
              diffusion_coeff=0.05, dt=2e-4, skin=0.4, num_steps=20, dtype="float64",
              log_every=1000)


def test_main_devices_two_on_the_cpu(tmp_path, capfd):
    y = tmp_path / "spheres.yaml"
    y.write_text("app: spheres\nparams:\n" + "".join(f"  {k}: {v}\n" for k, v in PARAMS.items()))
    out, ck = tmp_path / "out", tmp_path / "ck"
    assert main([str(y), "--device", "cpu", "--devices", "2", "--output-dir", str(out),
                 "--output-every", "10", "--checkpoint-dir", str(ck),
                 "--rank-timeout", "240"]) == 0
    said = capfd.readouterr().out
    assert "ranks 2, backend gloo, devices [cpu, cpu]" in said
    assert said.count("step 20/20") == 1  # rank 0 alone prints
    assert (out / "final.vtk").exists()
    with TrajectoryReader(str(out / "trajectory.mtrj")) as r:
        assert r.num_frames == 3  # steps 0, 10 and 20
    assert sorted(p.name for p in ck.iterdir()) == ["ckpt_000000000020.json",
                                                   "ckpt_000000000020.npz"]
    cfg = SpheresConfig(**PARAMS)
    from mundy_tpu_torch.driver.apps.spheres import SpheresSim

    flat = SpheresSim(cfg, device="cpu")
    got = load_checkpoint(str(ck / "ckpt_000000000020.npz"), flat.init())
    assert got.step == 20 and not bool(got.overflow)
    single = RowSpheresSim(cfg, device="cpu")
    s0 = flat.init()
    s = single.run_block(single.init(pos=s0.pos, key_words=s0.key), 10)
    s = single.run_block(s, 10)
    diff = got.pos.numpy() - single.positions(s).numpy()
    diff -= cfg.box_size * np.round(diff / cfg.box_size)
    assert np.abs(diff).max() < 1e-7


# the repo's own example YAMLs of the two balanced routes, cut to the CPU
BALANCED_YAMLS = {
    "lcp_spheres_100k": dict(num_spheres=400, box_size=14.0, num_steps=10, dtype="float64"),
    "granular_settling": dict(num_spheres=300, box_size=10.0, num_steps=40, dt=5e-4,
                              dtype="float64"),
}


@pytest.mark.parametrize("yaml", sorted(BALANCED_YAMLS))
def test_main_devices_two_runs_the_balanced_routes(yaml, tmp_path, capfd):
    over = BALANCED_YAMLS[yaml]
    out, ck = tmp_path / "out", tmp_path / "ck"
    steps = over["num_steps"]
    assert main([f"examples/{yaml}.yaml", "--device", "cpu", "--devices", "2",
                 "--set", *(f"{k}={v}" for k, v in over.items()), "--output-dir", str(out),
                 "--checkpoint-dir", str(ck), "--rank-timeout", "240"]) == 0
    said = capfd.readouterr().out
    assert said.count("ranks 2, backend gloo, devices [cpu, cpu]") == 1
    assert said.count("density-balanced z-slab") == 1
    assert said.count(f"step {steps}/{steps}") == 1  # rank 0 alone prints
    assert (out / "final.vtk").exists()
    assert sorted(p.name for p in ck.iterdir()) == [f"ckpt_{steps:012d}.json",
                                                   f"ckpt_{steps:012d}.npz"]
    sim = (LCPSpheresSim(LCPSpheresConfig(**over), device="cpu") if yaml.startswith("lcp")
           else GranularSim(GranularConfig(**over), device="cpu"))
    got = load_checkpoint(str(ck / f"ckpt_{steps:012d}.npz"), sim.init())
    assert got.step == steps and not bool(got.overflow)
    assert bool(torch.isfinite(got.pos).all())


def test_backend_rule():
    cpu = backend_plan(2, "cpu")
    assert (cpu.backend, cpu.stage) == ("gloo", False)
    one = backend_plan(1, "cuda", n_cards=1)
    assert (one.backend, one.stage, one.devices) == ("nccl", False, (torch.device("cuda", 0),))
    shared = backend_plan(2, "cuda", n_cards=1)
    assert (shared.backend, shared.stage) == ("gloo", True)
    assert shared.devices == (torch.device("cuda", 0),) * 2
    own = backend_plan(4, "cuda", n_cards=4)
    assert own.backend == "nccl" and [d.index for d in own.devices] == [0, 1, 2, 3]
    assert [d.index for d in backend_plan(4, "cuda", n_cards=2).devices] == [0, 1, 0, 1]
    assert "staged through pinned host buffers" in shared.describe()


UNPORTED = {
    "chromatin-chains": ("chromatin", ChromatinConfig(num_chains=7), ValueError,
                         "num_chains % ranks == 0"),
    "chromatin-hydro": ("chromatin", ChromatinConfig(num_chains=2, hydro="rpy_neighbors",
                                                     box_size=20.0),
                        ValueError, "runs hydro none, rpy_spectral, rpy_periphery"),
    "lcp-rpy_ring": ("lcp_spheres", LCPSpheresConfig(hydro="rpy_ring", num_spheres=10_001),
                     ValueError, "num_spheres % ranks"),
    "filaments-split": ("filaments", FilamentsConfig(num_filaments=5), ValueError,
                        "num_filaments % ranks == 0"),
    "no-app": ("proteins", None, ValueError, "no sharded engine for app 'proteins'"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_apps_raise(case):
    """What no sharded engine runs over 2 ranks is refused, each refusal
    naming its rule (LCP rpy_ring spheres that do not split into equal
    blocks too); every app has a route, and a config that splits passes."""
    app, cfg, err, match = UNPORTED[case]
    with pytest.raises(err, match=match):
        refuse_unported(app, cfg, 2)
    refuse_unported("chromatin", ChromatinConfig(num_chains=8, num_crosslinkers=16,
                                                 hydro="rpy_periphery",
                                                 periphery_radius=9.0), 2)
    refuse_unported("filaments", FilamentsConfig(num_filaments=8), 2)
    refuse_unported("lcp_spheres", LCPSpheresConfig(hydro="rpy_ring"), 1)


def test_spawn_ranks_needs_a_card_by_default():
    """spawn_ranks runs on the card unless the caller asks for the CPU:
    without a card a call with no device raises before any rank starts."""
    import multiprocessing

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        spawn_ranks(bodies.raise_on_rank, 2, args=(0,), timeout=60.0)
    assert not multiprocessing.active_children()


def test_refusals_of_the_engines():
    g = Group.single("cpu")
    poly = SpheresConfig(num_spheres=100, box_size=12.0, polydispersity=0.3, dtype="float64")
    with pytest.raises(ValueError, match="equal radii"):
        ShardedSim("spheres", RowSpheresSim(poly, device="cpu"), g)
    for kw in (dict(hydro="rpy_neighbors"), dict(polydispersity=0.3)):
        cfg = LCPSpheresConfig(num_spheres=100, box_size=12.0, dtype="float64", **kw)

        class _Lcp:  # the lcp route reads only the config before it refuses
            config = cfg

        with pytest.raises(ValueError, match="dry equal-radius"):
            ShardedSim("lcp_spheres", _Lcp(), g)
    gran = GranularConfig(num_spheres=100, box_size=10.0, dtype="float64")
    with pytest.raises(ValueError, match="at least 2 ranks"):
        ShardedSim("granular", GranularSim(gran, device="cpu"), g)
    for kw in (dict(shape="ellipsoid"), dict(friction=True)):
        cfg = RodsConfig(num_rods=100, box_size=24.0, dtype="float64", engine="nmat", **kw)

        class _Sim:  # the rods route reads only the config before it refuses
            config = cfg

        with pytest.raises(ValueError, match="frictionless spherocylinder"):
            ShardedSim("rods", _Sim(), g)


@pytest.mark.parametrize("app", ["spheres", "rods"])
def test_regrow_grows_the_row_capacity(app):
    if app == "spheres":
        cfg = SpheresConfig(num_spheres=300, box_size=12.0, diffusion_coeff=0.05,
                            dtype="float64")
        sim = RowSpheresSim(cfg, device="cpu")
    else:
        cfg = RodsConfig(num_rods=200, box_size=15.0, diffusion_coeff=0.05,
                         rot_diffusion_coeff=0.05, dtype="float64")
        sim = RowRodsSim(cfg, device="cpu")
    g = Group.single("cpu")
    roomy = ShardedSim(app, sim, g)
    tight = ShardedSim(app, sim, g, row_capacity=4)
    s0 = sim.init()
    want = sim.positions(roomy.run_block(s0, 6))
    st = tight.run_block(s0, 6)
    regrows = 0
    while bool(st.overflow):  # main's loop: regrow, retry from the last good state
        before = tight.engine.grid.row_capacity
        tight.regrow(s0)
        assert tight.engine.grid.row_capacity > before
        regrows += 1
        st = tight.run_block(s0, 6)
    assert regrows >= 1 and st.step == 6
    torch.testing.assert_close(sim.positions(st), want, rtol=0, atol=1e-12)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RankError, match="rank 0 fails on purpose"):
        spawn_ranks(bodies.raise_on_rank, 1, "cpu", args=(0,), timeout=60.0)


def test_a_hung_rank_is_killed_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 5"):
        spawn_ranks(bodies.sleep_on_rank, 1, "cpu", args=(600.0,), timeout=5.0)
    assert time.monotonic() - t0 < 30.0
