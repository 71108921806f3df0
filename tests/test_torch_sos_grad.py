"""The coefficient gradient of a biquad section (``ops/sos_grad.py``): the
plain version against a numpy reference in every layout the kernel takes,
the wrapper's choice between the kernel's vector and general routes, and,
on a card, the kernel against the plain version.

Tolerances, and why:

  * plain vs numpy: both round each product in float32 and add in
    float64, in different orders, so each sum is held within 1e-12 of the
    sum of its products' magnitudes (a sum of exact zeros must be zero).
  * kernel vs plain on the card: 1e-9 relative (``chip_smoke.py`` phase
    13 (b)'s tolerance: the same products, float64 sums in another
    order), the same bits on a second call, and the same bits in every
    layout (both routes add the same products in the same order).
"""

import numpy as np
import pytest
import torch

from ame_tpu_torch.ops import sos_grad as SG

NS = (1, 2, 3, 999)
CS = (1, 2, 3, 5)
LAYOUTS = ("halves", "separate", "unaligned")


def _inputs(n: int, c: int, layout: str, device: str = "cpu"):
    """numpy g [n, c] and vw [n, 2c] made from a seed, and (g, v, w) as
    tensors in `layout`: v and w the halves of one [n, 2c] tensor (as the
    backward passes them), separate tensors, or the halves of an [n, 2c]
    view one float past an allocation's start (rows not aligned)."""
    rng = np.random.default_rng(1000 * n + c)
    g = rng.standard_normal((n, c)).astype(np.float32)
    vw = (30.0 * rng.standard_normal((n, 2 * c))).astype(np.float32)
    tg = torch.from_numpy(g).to(device)
    tvw = torch.from_numpy(vw).to(device)
    if layout == "halves":
        v, w = tvw[:, :c], tvw[:, c:]
    elif layout == "separate":
        v, w = tvw[:, :c].clone(), tvw[:, c:].clone()
    else:
        flat = torch.empty(n * 2 * c + 1, device=device)
        flat[1:] = tvw.reshape(-1)
        off = flat[1:].view(n, 2 * c)
        v, w = off[:, :c], off[:, c:]
    return g, vw, (tg, v, w)


def _numpy_sums(g: np.ndarray, vw: np.ndarray):
    """(the five sums, the sum of each one's |products|): float32
    products, float64 sums."""
    n, c = g.shape
    v, w = vw[:, :c], vw[:, c:]

    def lag(a, j):
        return np.concatenate([np.zeros((j, c), np.float32), a])[:n]
    prods = [(g * lag(v, 0)), (g * lag(v, 1)), (g * lag(v, 2)),
             (g * lag(w, 1)), (g * lag(w, 2))]
    assert all(p.dtype == np.float32 for p in prods)
    sums = np.array([p.astype(np.float64).sum() for p in prods])
    sums[3:] *= -1.0
    return sums, np.array([np.abs(p.astype(np.float64)).sum()
                           for p in prods])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("n", NS)
def test_plain_matches_numpy(n, c, layout):
    g, vw, args = _inputs(n, c, layout)
    got = SG.sos_grad_plain(*args)
    assert got.dtype == torch.float64 and got.shape == (5,)
    want, scale = _numpy_sums(g, vw)
    assert np.all(np.abs(got.numpy() - want) <= 1e-12 * scale)
    assert torch.equal(SG.sos_grad(*args), got)


def _meta(args):
    return ([t.stride(0) for t in args], [t.data_ptr() for t in args])


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_route_of_layouts(layout, c):
    """The vector route exactly for the halves of one tensor at C <= 2."""
    _, _, args = _inputs(999, c, layout)
    assert SG.vector_route(c, *_meta(args)) == (layout == "halves"
                                                and c <= 2)


@pytest.mark.parametrize("C, ld, ptr, want", [
    (2, (2, 4, 4), (0, 1024, 1032), True),      # [N, 4] halves, aligned
    (1, (1, 2, 2), (4, 1024, 1028), True),      # [N, 2] halves
    (2, (2, 8, 8), (0, 1024, 1032), True),      # halves of wider rows
    (2, (2, 4, 4), (0, 1040, 1048), True),      # the rows after the first
    (2, (2, 4, 4), (0, 1028, 1036), False),     # rows not 16-byte aligned
    (2, (2, 6, 6), (0, 1024, 1032), False),     # 24-byte rows
    (2, (2, 4, 4), (4, 1024, 1032), False),     # g rows not 8-byte aligned
    (2, (3, 4, 4), (0, 1024, 1032), False),     # g's 12-byte rows
    (2, (2, 4, 8), (0, 1024, 1032), False),     # two row strides
    (2, (2, 4, 4), (0, 1024, 4096), False),     # separate tensors
    (3, (3, 6, 6), (0, 1024, 1036), False),     # C > 2: general route
    (64, (64, 128, 128), (0, 1024, 1280), False),
])
def test_vector_route(C, ld, ptr, want):
    assert SG.vector_route(C, ld, ptr) is want


@pytest.mark.parametrize("C", [0, 65, 128])
def test_route_refuses_c(C):
    with pytest.raises(ValueError, match="C must be in 1..64"):
        SG.vector_route(C, (C, 2 * C, 2 * C), (0, 1024, 1024 + 4 * C))


def test_cpu_tensors_never_launch():
    _, _, args = _inputs(64, 2, "halves")
    before = (SG.sos_grad_cuda.launches, SG.sos_grad_cuda.vector_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SG.sos_grad_cuda(*args)
    assert (SG.sos_grad_cuda.launches,
            SG.sos_grad_cuda.vector_launches) == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU build")
    for n in NS:
        for c in CS:
            sums = []
            for layout in LAYOUTS:
                _, _, args = _inputs(n, c, layout, "cuda")
                vec0 = SG.sos_grad_cuda.vector_launches
                got = SG.sos_grad_cuda(*args)
                again = SG.sos_grad_cuda(*args)
                want = SG.sos_grad_plain(*args)
                rel = ((got - want).abs()
                       / want.abs().clamp_min(1e-300)).max().item()
                assert rel <= 1e-9 and torch.equal(got, again), (n, c, layout)
                assert (SG.sos_grad_cuda.vector_launches - vec0 == 2
                        * (layout == "halves" and c <= 2)), (n, c, layout)
                sums.append(got)
            assert all(torch.equal(s, sums[0]) for s in sums), (n, c)
