"""The port's CLI: the configurator against the JAX package's, and
`main` on the CPU (results, checkpoints, bit-equal continuation, the
card as the default device)."""

import dataclasses
import glob
import os
import pathlib

import numpy as np
import pytest
import torch

from mundy_tpu.core.config import config_from_dict as jax_config_from_dict
from mundy_tpu.driver import configurator as jcfg
from mundy_tpu_torch.core.config import ConfigError, load_yaml
from mundy_tpu_torch.driver import configurator as tcfg
from mundy_tpu_torch.driver.apps.rods import RodsConfig, RodsSim
from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim
from mundy_tpu_torch.driver.apps.spheres import SpheresSim
from mundy_tpu_torch.driver.main import main
from mundy_tpu_torch.io.trajectory import TrajectoryReader

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted(glob.glob(str(ROOT / "examples" / "*.yaml")))


def test_all_apps_registered():
    assert tcfg.available_apps() == jcfg.available_apps() == [
        "chromatin", "filaments", "granular", "lcp_spheres", "rods", "spheres"]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: os.path.basename(p))
def test_example_yaml_parses_as_the_reference(path):
    spec = load_yaml(path)
    app, cfg = tcfg.config_from_spec(spec)
    want = jax_config_from_dict(jcfg._registry()[app][0], spec["params"],
                                path=f"{app}.params")
    assert type(cfg).__name__ == type(want).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_build_with_overrides(tmp_path):
    y = tmp_path / "c.yaml"
    y.write_text("app: spheres\nparams:\n  num_spheres: 100\n  box_size: 12.0\n")
    cfg, sim = tcfg.build_simulation_from_yaml(str(y), {"num_steps": 5, "dtype": "float64"},
                                               device="cpu")
    assert (cfg.num_spheres, cfg.num_steps, cfg.dtype) == (100, 5, "float64")
    assert isinstance(sim, SpheresSim) and sim.device.type == "cpu"
    assert sim.dtype == torch.float64


def test_unknown_app_or_key_lists_the_choices():
    with pytest.raises(ConfigError, match="available: .*granular"):
        tcfg.build_simulation({"app": "bogus"}, device="cpu")
    with pytest.raises(ConfigError, match="available"):
        tcfg.build_simulation({"params": {}}, device="cpu")
    with pytest.raises(ConfigError, match="unknown keys .*valid keys: .*num_spheres"):
        tcfg.build_simulation({"app": "spheres", "params": {"nope": 1}}, device="cpu")


_RODS = dict(num_rods=200, box_size=24.0)


@pytest.mark.parametrize("over", [
    {}, {"engine": "rows"}, {"engine": "nmat"}, {"shape": "ellipsoid"}, {"friction": True},
    {"box_size": 13.0}], ids=["auto", "rows", "nmat", "ellipsoid", "friction", "small_box"])
def test_make_rods_sim_follows_the_reference(over):
    """The port builds its RowRodsSim where the reference builds its
    RowRodsSim, and its RodsSim where the reference builds RodsSim."""
    kw = dict(_RODS, **over)
    want = type(jcfg._registry()["rods"][1](jax_config_from_dict(
        jcfg._registry()["rods"][0], kw))).__name__
    assert want in ("RowRodsSim", "RodsSim")
    sim = tcfg.make_rods_sim(RodsConfig(**kw), device="cpu")
    assert type(sim).__name__ == want
    assert isinstance(sim, RowRodsSim if want == "RowRodsSim" else RodsSim)


def _yaml(tmp_path, app, **params):
    y = tmp_path / f"{app}.yaml"
    body = "".join(f"  {k}: {v}\n" for k, v in params.items())
    y.write_text(f"app: {app}\nparams:\n{body}")
    return str(y)


def test_main_writes_frames_and_final_vtk(tmp_path):
    y = _yaml(tmp_path, "spheres", num_spheres=64, box_size=10.0, num_steps=20,
              diffusion_coeff=0.1)
    out = tmp_path / "results"
    assert main([y, "--output-dir", str(out), "--output-every", "5", "--device", "cpu"]) == 0
    with TrajectoryReader(str(out / "trajectory.mtrj")) as r:
        assert (r.n, r.num_frames) == (64, 5)  # the initial frame + steps 5, 10, 15, 20
        assert [r.read(i)[0] for i in range(5)] == [0, 5, 10, 15, 20]
        assert np.isfinite(r.read(4)[2]).all()
    assert (out / "final.vtk").read_text().startswith("# vtk")


# one config per engine kind: the flat cell list, granular (the pair list
# and its history), a row engine, and the (N, K) rods engine with friction
# (the tangential history and the lagged velocities through a checkpoint)
_RESUME = {
    "spheres": dict(num_spheres=200, box_size=10.0, diffusion_coeff=0.1, skin=0.1),
    "granular": dict(num_spheres=150, box_size=8.0, dt=5e-4),
    "rods": dict(num_rods=150, box_size=24.0, diffusion_coeff=0.05,
                 rot_diffusion_coeff=0.05, skin=0.1),
    "rods_friction": dict(num_rods=200, box_size=14.0, diffusion_coeff=0.05,
                          rot_diffusion_coeff=0.05, skin=0.1, engine="nmat",
                          friction=True, max_neighbors=16),
}


def _final(ck):
    with np.load(os.path.join(ck, "ckpt_000000000010.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("app", sorted(_RESUME))
def test_continue_is_bit_equal_to_one_run(app, tmp_path):
    """10 steps in one run (checkpoints every 5) equal 5 steps, then
    --continue for 5, bit for bit, output frames included."""
    y = _yaml(tmp_path, app.split("_")[0], num_steps=10, dtype="float64", **_RESUME[app])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--device", "cpu", "--output-every", "5"]
    assert main([y, "--checkpoint-dir", a, "--checkpoint-every", "5",
                 "--output-dir", a, *args]) == 0
    assert main([y, "--checkpoint-dir", b, "--set", "num_steps=5", "--output-dir", b,
                 *args]) == 0
    assert main([y, "--checkpoint-dir", b, "--continue", "--output-dir", b, *args]) == 0
    fa, fb = _final(a), _final(b)
    assert fa.keys() == fb.keys()
    step_key = next(k for k in fa if k.endswith("|step"))
    assert int(fa[step_key]) == 10
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    ta, tb = (pathlib.Path(d, "trajectory.mtrj").read_bytes() for d in (a, b))
    assert ta == tb


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    y = _yaml(tmp_path, "spheres", num_spheres=64, box_size=10.0, num_steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([y])


def test_main_refuses_several_devices(tmp_path, capfd):
    """--devices 2 runs every app (tests/test_torch_sharded.py,
    test_torch_*_shard.py, LCP rpy_ring below); what no sharded engine runs
    raises before any rank starts (no plan line), each refusal naming its
    rule: the repo's hp1_chromatin.yaml (7 chains over 2 ranks), chromatin
    hydro outside the three modes, and crosslinkers, filaments and rpy_ring
    spheres that do not split."""
    hp1 = str(ROOT / "examples" / "hp1_chromatin.yaml")
    lcp = str(ROOT / "examples" / "lcp_spheres_100k.yaml")
    cases = [
        (hp1, (), ValueError, "num_chains % ranks"),
        (hp1, ("num_chains=8", "hydro=rpy_neighbors"), ValueError,
         "runs hydro none, rpy_spectral, rpy_periphery"),
        (hp1, ("num_chains=8", "num_crosslinkers=3"), ValueError, "num_crosslinkers % ranks"),
        (_yaml(tmp_path, "filaments", num_filaments=5), (), ValueError,
         "num_filaments % ranks"),
        (lcp, ("hydro=rpy_ring", "num_spheres=4097"), ValueError, "num_spheres % ranks"),
    ]
    for y, sets, err, match in cases:
        with pytest.raises(err, match=match):
            main([y, "--device", "cpu", "--devices", "2", "--set", *sets])
    assert "ranks 2" not in capfd.readouterr().out


def test_main_devices_runs_rpy_ring(tmp_path, capfd):
    """--devices 2 with LCP hydro=rpy_ring: LCPSpheresSim over the two ranks
    (no ShardedSim), its plan line once, rank 0's checkpoint with every
    sphere finite and no overflow."""
    lcp = str(ROOT / "examples" / "lcp_spheres_100k.yaml")
    ck = tmp_path / "ck"
    assert main([lcp, "--device", "cpu", "--devices", "2", "--checkpoint-dir", str(ck),
                 "--set", "hydro=rpy_ring", "num_spheres=200", "box_size=12.0",
                 "num_steps=4", "dtype=float64"]) == 0
    out = capfd.readouterr().out
    assert out.count("sharded over 2 ranks: LCP rpy_ring") == 1
    assert out.count("step 4/4") == 1
    arrays = {k.split("|", 1)[1]: v for k, v in np.load(ck / "ckpt_000000000004.npz").items()}
    assert arrays["pos"].shape == (200, 3) and np.isfinite(arrays["pos"]).all()
    assert not arrays["overflow"] and arrays["step"] == 4
