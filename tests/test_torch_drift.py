"""The port's f32-vs-f64 drift harness (mundy_tpu_torch/driver/drift.py) on
the CPU, both legs on device="cpu".

- the bars of tests/test_drift.py at n = 600, 20 steps, for both configs,
  through the harness's command line;
- the identical start: the deviation before any step is the float32 cast
  of the positions, and the key words are equal;
- the matched noise: both legs draw brownian_velocity_keyed, whose float32
  normals cast up equal the float64 draw, and neither leg reaches the
  float64 stream (uniform_pm1 / normal);
- parity with benchmarks/drift_f32.py for `spheres`: from the reference
  harness's float64 start and key, the port's float64 leg is within 1e-8 of
  the reference's at checkpoints 1, 2 and 5 (measured 2.13e-9, 2.13e-9,
  2.40e-9: an ulp of a float32 normal between the two erf_inv's is ~1e-9 of
  position), and its float32 leg within 1e-5 of the reference's at
  checkpoint 1 (measured 2.38e-7, two ulps of a coordinate near 18);
- a device="cuda" run without a card raises.

LCP parity with the JAX harness is left out: its JAX compile is the
suite's most expensive kind, and tests/test_torch_lcp_spheres.py already
holds the LCP app against the JAX app.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mundy_tpu_torch.driver import drift
from mundy_tpu_torch.driver.apps import lcp_spheres as lcp_app
from mundy_tpu_torch.driver.apps import spheres as spheres_app
from mundy_tpu_torch.dynamics import brownian

torch.set_num_threads(2)

N, STEPS = 600, 20


@pytest.fixture(scope="module", params=["spheres", "lcp"])
def cli_run(request):
    """(config, the returned result, the JSON line the command printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = drift.main([request.param, str(N), "--steps", str(STEPS), "--device", "cpu"])
    return request.param, out, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_drift_bars_of_the_reference_test(cli_run):
    config, out, printed = cli_run
    assert printed == out
    keys = {"config", "n", "backend_f32", "per_step_drift", "divergence"}
    if config == "lcp":
        keys |= {"max_overlap_f64", "max_overlap_f32"}
    assert set(out) == keys
    assert (out["config"], out["n"], out["backend_f32"]) == (config, N, "cpu")
    assert list(out["divergence"]) == ["1", "2", "5", "10", "20"]
    assert out["per_step_drift"] == out["divergence"]["1"]
    # the bars of tests/test_drift.py
    assert out["per_step_drift"] < 1e-4, out
    if config == "spheres":
        assert out["divergence"]["20"] < 3e-2, out
    else:
        assert out["max_overlap_f32"] < 5e-4, out
        assert out["max_overlap_f64"] < 5e-4, out


@pytest.mark.parametrize("pair", [drift.spheres_pair, drift.lcp_pair],
                         ids=["spheres", "lcp"])
def test_identical_start(pair):
    (sim64, s64), (sim32, s32), box = pair(200, device="cpu")
    assert (sim64.device.type, s64.pos.dtype) == ("cpu", torch.float64)
    assert (sim32.device.type, s32.pos.dtype) == ("cpu", torch.float32)
    assert s32.key == s64.key
    cast = (s64.pos - s64.pos.to(torch.float32).to(torch.float64)).abs().max().item()
    dev = drift._minimage_dev(s64.pos, s32.pos, box)
    assert dev <= cast < 2.0**-24 * box
    assert s32.step == s64.step == 0


def test_legs_draw_the_same_keyed_normals(monkeypatch):
    """One (key, step, gid set): the float32 draw cast up equals the float64
    draw. Both apps draw through brownian_velocity_keyed in both legs, and
    the float64 stream (uniform_pm1 / normal) is never reached."""
    key, step = (0x1234ABCD, 0x9E3779B9), 7
    gid = torch.tensor([0, 1, 2, 599, 12345, 2**20 - 1], dtype=torch.int32)
    v32 = brownian.brownian_velocity_keyed(key, step, gid, 1.0, 0.5, dtype=torch.float32)
    v64 = brownian.brownian_velocity_keyed(key, step, gid, 1.0, 0.5, dtype=torch.float64)
    assert v64.dtype == torch.float64 and v32.dtype == torch.float32
    assert torch.equal(v32.to(torch.float64), v64)

    def refuse(*args, **kwargs):
        raise AssertionError("a leg drew from the float64 stream")

    monkeypatch.setattr(brownian, "uniform_pm1", refuse)
    monkeypatch.setattr(brownian, "normal", refuse)
    seen = []
    for app in (spheres_app, lcp_app):
        keyed = app.brownian_velocity_keyed

        def spy(key, step, gid, *args, dtype=torch.float32, _app=app, _keyed=keyed, **kw):
            seen.append((_app.__name__.rsplit(".", 1)[-1], dtype, step))
            return _keyed(key, step, gid, *args, dtype=dtype, **kw)

        monkeypatch.setattr(app, "brownian_velocity_keyed", spy)
    for pair in (drift.spheres_pair, drift.lcp_pair):
        (sim64, s64), (sim32, s32), _ = pair(200, device="cpu")
        sim64.run_block(s64, 1)
        sim32.run_block(s32, 1)
    draws = {(app, dtype) for app, dtype, _ in seen}
    assert draws == {(app, dt) for app in ("spheres", "lcp_spheres")
                     for dt in (torch.float64, torch.float32)}
    assert all(step == 0 for _, _, step in seen)


def test_spheres_parity_with_the_reference_harness():
    """From benchmarks/drift_f32.py's own float64 start and key, the port's
    legs follow the reference harness's legs."""
    import jax

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
    import drift_f32

    (jsim64, js64), (jsim32, js32), jbox = drift_f32.spheres_pair(N)
    (sim64, s64), (sim32, s32), box = drift.spheres_pair(
        N, device="cpu", pos=torch.from_numpy(np.array(js64.pos)),
        key_words=np.asarray(jax.random.key_data(js64.key)))
    assert box == jbox
    np.testing.assert_array_equal(s32.pos.numpy(), np.asarray(js32.pos))
    cpu = jax.devices("cpu")[0]
    done = 0
    for k in (1, 2, 5):
        with jax.default_device(cpu):
            js64 = jsim64.run_block(js64, k - done)
            if k == 1:
                js32 = jsim32.run_block(js32, 1)
        s64 = sim64.run_block(s64, k - done)
        if k == 1:
            s32 = sim32.run_block(s32, 1)
            assert drift._minimage_dev(s32.pos, np.asarray(js32.pos), box) <= 1e-5
        done = k
        assert drift._minimage_dev(s64.pos, np.asarray(js64.pos), box) <= 1e-8, k


def test_cuda_leg_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for pair in (drift.spheres_pair, drift.lcp_pair):
        with pytest.raises(RuntimeError, match="CUDA"):
            pair(50)
    with pytest.raises(RuntimeError, match="CUDA"):
        drift.main(["lcp", "50"])
