"""The CUDA kernels K1/K2 against their plain torch versions, on a card.

Card-only (marker ``cuda``): without a CUDA device every test skips inside
the fixture.  This file imports no jax, so it also runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On the card the kernels must equal their plain versions bitwise: they are
built with ``-fmad=false`` and keep the plain version's operand order.
"""

import numpy as np
import pytest
import torch

from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.scene.builtin import cornell_box
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors

B0 = 37   # rows of 128 rays; row 1 and every third row after it dead


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tables(name, dev):
    rng = np.random.default_rng(9)
    if name == "cornell":
        s = build_scene_tensors(cornell_box(), device=dev)
        v = (s.tri_v0, s.tri_v1, s.tri_v2)
        attrs = ic._prep_attrs(s)
    else:
        n = 1000
        v0 = rng.uniform(0, 1, (n, 3))
        v = [v0, v0 + rng.normal(scale=0.1, size=(n, 3)), v0 + rng.normal(scale=0.1, size=(n, 3))]
        v = [torch.tensor(x, dtype=torch.float32, device=dev) for x in v]
        attrs = torch.tensor(rng.normal(size=(n, ic.ATTR_K)), dtype=torch.float32, device=dev)
    rows = ic._prep_tris(*v)
    pts = torch.cat(v).cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    ext = (hi - lo)[:, None, None]
    o = rng.uniform(lo[:, None, None] - 0.1 * ext, hi[:, None, None] + 0.1 * ext, (3, B0, 128))
    q = dict(
        o3=o, d3=rng.normal(size=(3, B0, 128)),
        tmax=rng.uniform(0, 1.5 * float(ext.max()), (B0, 128)),
    )
    q = {k: torch.tensor(x, dtype=torch.float32, device=dev) for k, x in q.items()}
    q["excl"] = torch.tensor(rng.integers(0, rows.shape[0], (B0, 128)), dtype=torch.int32, device=dev)
    live = torch.ones(B0, dtype=torch.int32, device=dev)
    live[1::3] = 0
    q["live"] = live
    return rows, attrs, q


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "soup1000"])
def test_kernels_equal_plain_on_card(name, cuda_device):
    rows, attrs, q = _tables(name, cuda_device)
    before = dict(ic.LAUNCHES)
    got = ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs)
    occ = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == {"closest": before["closest"] + 1, "any": before["any"] + 1}
    want = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], rows, attrs)
    for field, a, b in zip(("t", "id", "u", "v", "attrs"), got, want):
        assert torch.equal(a, b), field
    assert torch.equal(
        occ, ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    )
    hit = got[0] < ic.BIG
    assert 0.05 < float(hit.float().mean()) < 0.95
    assert not bool(hit[1::3].any()) and not bool(occ[1::3].any())


@pytest.mark.cuda
def test_kernel_launch_errors_raise(cuda_device):
    """A CUDA tensor never falls back to the plain version: a bad input
    raises before launch."""
    rows, attrs, q = _tables("cornell", cuda_device)
    with pytest.raises(ValueError, match="on cpu"):
        ic.closest_dense(q["live"], q["o3"], q["d3"].cpu(), rows, attrs)
