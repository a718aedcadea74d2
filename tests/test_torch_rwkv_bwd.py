"""K6's gradient on the CPU: the plain backward (``rwkv6_scan_bwd_plain``,
the CPU path of the port's autograd Function) and the mirror of the
backward kernel's order of summation (``rwkv6_scan_bwd_split_plain``)
against ``jax.grad`` of the reference's oracle,
``repro/kernels/ref.py::rwkv6_scan_ref``, for sum(y dy) + sum(S_final dS)
with and without the final state's gradient, on numpy-seeded inputs:
head dims 8, 32 and 64, sequence lengths around the 16-step chunks the
forward saves (1, 15, 16, 17, 40), batch 1 and 2: at hd 32 and 64 the
kernel's clusters of 2 and 4 blocks of 16 rows, at hd 8 one block. The
kernel itself, on the card: tests/test_torch_cuda.py.

Tolerance: GRAD_TOL = 1e-4 of each gradient's largest magnitude
(tests/test_torch_train.py's): both sides compute in float32 and differ
only in summation order."""
import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as tscan  # noqa: E402

GRAD_TOL = 1e-4
NAMES = "dr dk dv dw du dstate0".split()


def _inputs(B, S, H, hd):
    rs = np.random.RandomState(1000 * B + 10 * S + hd)

    def randn(*shape):
        return rs.standard_normal(shape).astype(np.float32)
    r, k, v = [randn(B, S, H, hd) * 0.5 for _ in range(3)]
    w = (1 / (1 + np.exp(-randn(B, S, H, hd))) * 0.5 + 0.4).astype(
        np.float32)
    return ([r, k, v, w, randn(H, hd) * 0.1, randn(B, H, hd, hd) * 0.1],
            randn(B, S, H, hd), randn(B, H, hd, hd))


@functools.lru_cache(maxsize=None)
def _reference(B, S, hd):
    """The inputs, the boundaries of the plain forward, and jax.grad of
    the oracle with the final state's gradient (True) and without
    (False)."""
    xs, dy, ds = _inputs(B, S, 2, hd)

    def loss(args, dy, ds):
        y, st = ref.rwkv6_scan_ref(*args)
        return jnp.sum(y * dy) + jnp.sum(st * ds)
    grad = jax.jit(jax.grad(loss))
    jx = [jnp.asarray(a) for a in xs]
    want = {with_ds: [np.asarray(g) for g in grad(
                jx, jnp.asarray(dy), jnp.asarray(ds if with_ds else 0 * ds))]
            for with_ds in (False, True)}
    tx = [torch.from_numpy(a) for a in xs]
    bnd = []
    tscan.rwkv6_scan_plain(*tx, boundaries=bnd)
    assert len(bnd) == -(-S // tscan.SAVE_EVERY)
    return tx, torch.stack(bnd), torch.from_numpy(dy), \
        torch.from_numpy(ds), want


def _held(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (what, name, err)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("hd", [8, 32, 64])
def test_bwd_plain_matches_reference_grad(B, S, hd):
    tx, bnd, dy, ds, want = _reference(B, S, hd)
    for with_ds in (False, True):
        got = tscan.rwkv6_scan_bwd_plain(*tx[:5], bnd, dy,
                                         ds if with_ds else None)
        _held(got, want[with_ds], f"plain, dstate {with_ds}")


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("hd", [8, 32, 64])
def test_bwd_split_plain_matches_reference_grad(B, S, hd):
    tx, bnd, dy, ds, want = _reference(B, S, hd)
    for with_ds in (False, True):
        got = tscan.rwkv6_scan_bwd_split_plain(*tx[:5], bnd, dy,
                                               ds if with_ds else None)
        _held(got, want[with_ds], f"split, dstate {with_ds}")


def test_bwd_split_plain_follows_the_kernels_shape():
    """The mirror's block shape is the kernel's: the constants of
    csrc/rwkv6_scan_bwd.cu, and its chunk is the forward's save interval."""
    src = (Path(tscan.__file__).resolve().parents[1] / "csrc" /
           "rwkv6_scan_bwd.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert (const["TC"], const["RB"], const["R"], const["C"], const["U"]) \
        == (tscan.SAVE_EVERY, tscan.BWD_ROWS, tscan.BWD_THREAD_ROWS,
            tscan.BWD_THREAD_COLS, tscan.BWD_SUB)


def test_bwd_split_plain_close_to_plain_at_width():
    """At RWKV-6's head dim, a few chunks and several heads, the mirror
    and the plain backward agree far inside GRAD_TOL (float32 both, other
    orders): 1e-6 of each gradient's scale."""
    rs = np.random.RandomState(5)
    xs = [torch.from_numpy(rs.standard_normal(s).astype(np.float32) * 0.5)
          for s in [(2, 50, 3, 64)] * 3]
    xs.append(torch.sigmoid(torch.from_numpy(rs.standard_normal(
        (2, 50, 3, 64)).astype(np.float32))) * 0.5 + 0.4)
    xs += [torch.from_numpy(rs.standard_normal(s).astype(np.float32) * 0.1)
           for s in [(3, 64), (2, 3, 64, 64)]]
    dy = torch.from_numpy(rs.standard_normal((2, 50, 3, 64)).astype(
        np.float32))
    bnd = []
    tscan.rwkv6_scan_plain(*xs, boundaries=bnd)
    bnd = torch.stack(bnd)
    got = tscan.rwkv6_scan_bwd_split_plain(*xs[:5], bnd, dy)
    want = tscan.rwkv6_scan_bwd_plain(*[x.double() for x in xs[:5]],
                                      bnd.double(), dy.double())
    for name, g, w in zip(NAMES, got, want):
        assert float((g.double() - w).abs().max()) <= \
            1e-6 * float(w.abs().max()), name
