"""The CUDA kernels of the torch port vs their plain PyTorch versions.

These need an NVIDIA GPU with nvcc and skip without one. The file imports
no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Bounds: float32 within 2e-5 max(max|f|, 1), the bound of
tests/test_pallas_row_central.py (rsqrt approximations and summation
order); float64 within 1e-12 max(max|f|, 1) (summation order only).
"""

import numpy as np
import pytest
import torch

from mundy_tpu_torch.neighbor import rows as tr
from mundy_tpu_torch.ops.kernels import row_central as k1

_DT = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,box,cutoff,align", [(4000, 12.0, 1.4, 8),
                                                 (3000, 13.0, 1.4, 1),
                                                 (80000, 40.0, 1.4, 8)])
def test_k1_kernel_matches_plain(cuda_device, dtype, n, box, cutoff, align):
    """align=1 gives nz = 9, which the TPU kernel refused; n=80000 gives
    R = 288: rows longer than one 256-thread pass, and in float64 more
    than 48 KB of shared memory."""
    td = _DT[dtype]
    rng = np.random.default_rng(11)
    grid = tr.make_row_grid([0, 0, 0], [box] * 3, cutoff, n, dtype=td,
                            align=align, device=cuda_device)
    ts = tr.build_rows(torch.as_tensor(rng.uniform(0, box, (n, 3)), dtype=td,
                                       device=cuda_device),
                       torch.arange(n, dtype=torch.int32, device=cuda_device),
                       grid)
    before = k1.row_hertzian_forces_sym.launches
    got = k1.row_hertzian_forces_sym(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
    torch.cuda.synchronize()
    assert k1.row_hertzian_forces_sym.launches == before + 1
    ref = k1.row_hertzian_forces_plain(ts.pos, (box,) * 3, 0.5, 1000.0, 0.3)
    m = ts.valid
    assert bool(torch.isfinite(got).all())
    err = (got[m] - ref[m]).abs().max().item()
    fmax = ref[m].abs().max().item()
    assert fmax > 0
    assert err <= (1e-12 if dtype == "float64" else 2e-5) * max(fmax, 1.0)
