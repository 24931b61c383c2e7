"""gsrt_torch pair expansion (`ops/pair_expand.py`) against the JAX
package's fused Pallas kernel (interpret mode, CPU), on the same NumPy
tables.

Tolerances: the copy mode is compared bit for bit, through the fused entry
point (`expand_pairs_fused`) and through the one that takes the source row
from outside the kernel (`expand_pairs`), dead sources included, at the
compact stream's 8 table rows and the f32 stream's 11. In the emit mode the
tile ids, the bf16 Cholesky words and rgba8 are exact, and each u16 mean
code may differ by one step (f32 rounding of the tile-relative mean).
The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py, which needs a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.ops import pair_expand as j_pe

from gsrt_torch.ops import pair_expand as t_pe
from test_torch_gpu import expand_edge_cases

DEAD = t_pe._DEAD_BASE
assert DEAD == j_pe._DEAD_BASE


def _bases(rng, n, n_live, lo=1, hi=9):
    """Run lengths for the first n_live sources, 0 for the rest; base is
    the exclusive prefix sum with the dead sentinel."""
    runs = np.zeros(n, np.int64)
    runs[:n_live] = rng.integers(lo, hi, n_live)
    base = np.where(runs > 0, np.cumsum(runs) - runs, DEAD).astype(np.int32)
    return base, int(runs.sum())


def _table(rng, rows, n, base):
    tab = rng.integers(-2**31, 2**31 - 1, (rows, n), dtype=np.int64)
    tab = tab.astype(np.int32)
    tab[1] = base
    return tab


def _unit_table(rng, n, n_live, ntx, nty, tile_w, tile_h):
    """A level-2 unit table as the group stream builds it: geometry word
    x0 | ys << 12 | w << 24, base, mean x/y bits, qab, qcd, rgba."""
    x0 = rng.integers(0, ntx, n)
    w = np.minimum(rng.integers(1, 4, n), ntx - x0)
    ys = rng.integers(0, nty, n)
    rows = np.minimum(rng.integers(1, 3, n), nty - ys)
    runs = np.where(np.arange(n) < n_live, rows * w, 0)
    base = np.where(runs > 0, np.cumsum(runs) - runs, DEAD).astype(np.int32)
    mx = ((x0 + w / 2) * tile_w + rng.normal(0, 40, n)).astype(np.float32)
    my = ((ys + rows / 2) * tile_h + rng.normal(0, 40, n)).astype(np.float32)
    mx[:4] = [3000.0, -2500.0, 0.5, 70.0]     # coarse tier and saturation
    words = rng.integers(-2**31, 2**31 - 1, (3, n)).astype(np.int32)
    tab = np.stack([(x0 | (ys << 12) | (w << 24)).astype(np.int32), base,
                    mx.view(np.int32), my.view(np.int32), *words,
                    np.zeros(n, np.int32)])
    return tab, base, int(runs.sum())


def _jax_fused(tab, base, mp):
    out = j_pe.expand_pairs_fused(jnp.asarray(tab.view(np.float32)),
                                  jnp.asarray(base), mp, interpret=True)
    return np.asarray(out).view(np.int32)


def _jax_expand_pairs(tab, base, mp):
    """The JAX kernel takes row counts that are multiples of 8: pad the
    table with zero rows and cut them off again."""
    rows = tab.shape[0]
    padded = np.concatenate(
        [tab, np.zeros((-rows % 8, tab.shape[1]), np.int32)])
    out = j_pe.expand_pairs(jnp.asarray(padded.view(np.float32)),
                            jnp.asarray(base), mp, interpret=True)
    return np.asarray(out).view(np.int32)[:rows]


@pytest.mark.parametrize("n,n_live,slack", [
    (700, 650, 300),     # dead tail and spare pair slots
    (1500, 1500, 0),     # every source live, exact fit
    (900, 800, -500),    # pair buffer smaller than the view: truncation
])
def test_copy_mode_matches_jax_bitwise(n, n_live, slack):
    rng = np.random.default_rng(n)
    base, total = _bases(rng, n, n_live)
    mp = total + slack
    tab = _table(rng, 8, n, base)
    got = t_pe.expand_pairs_fused(torch.as_tensor(tab),
                                  torch.as_tensor(base), mp)
    np.testing.assert_array_equal(got.numpy(), _jax_fused(tab, base, mp))


@pytest.mark.parametrize("rows", [8, 11])
@pytest.mark.parametrize("n,n_live,slack", [
    (700, 650, 300),     # dead tail and spare pair slots
    (900, 800, -500),    # pair buffer smaller than the view: truncation
    (64, 0, 256),        # no live source at all
])
def test_expand_pairs_matches_jax_and_fused_bitwise(n, n_live, slack, rows):
    rng = np.random.default_rng(n + rows)
    base, total = _bases(rng, n, n_live)
    mp = total + slack
    tab = _table(rng, rows, n, base)
    got = t_pe.expand_pairs(torch.as_tensor(tab), torch.as_tensor(base), mp)
    assert got.shape == (rows, mp) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_expand_pairs(tab, base, mp))
    fused = t_pe.expand_pairs_fused(torch.as_tensor(tab),
                                    torch.as_tensor(base), mp)
    assert torch.equal(got, fused)


def test_copy_mode_no_live_sources():
    rng = np.random.default_rng(1)
    base = np.full(64, DEAD, np.int32)
    tab = _table(rng, 8, 64, base)
    got = t_pe.expand_pairs_fused(torch.as_tensor(tab),
                                  torch.as_tensor(base), 256)
    np.testing.assert_array_equal(got.numpy(), _jax_fused(tab, base, 256))


@pytest.mark.parametrize("seed,slack", [(0, 400), (1, -300)])
def test_emit_mode_matches_jax(seed, slack):
    rng = np.random.default_rng(seed)
    ntx, nty, tw, th = 8, 16, 32, 16
    T = ntx * nty
    tab, base, total = _unit_table(rng, 1200, 1100, ntx, nty, tw, th)
    mp = total + slack
    live = min(total, mp)
    j = np.asarray(j_pe.expand_pairs_binned(
        jnp.asarray(tab.view(np.float32)), jnp.asarray(base), mp,
        total=jnp.int32(live), ntx=ntx, T=T, tile_w=tw, tile_h=th,
        interpret=True))
    t = t_pe.expand_pairs_binned(
        torch.as_tensor(tab[:t_pe.EMIT_TAB_ROWS].copy()),
        torch.as_tensor(base), mp,
        total=torch.tensor(live, dtype=torch.int32), ntx=ntx, T=T,
        tile_w=tw, tile_h=th).numpy()
    assert t.shape == (t_pe.EMIT_ROWS, mp)
    np.testing.assert_array_equal(t[4], j[4])     # tile id, T past total
    assert (t[4, live:] == T).all() and (t[4, :live] < T).all()
    np.testing.assert_array_equal(t[1:4], j[1:4])       # qab, qcd, rgba
    for shift in (16, 0):                               # mean x, mean y
        tc, jc = (t[0] >> shift) & 0xFFFF, (j[0] >> shift) & 0xFFFF
        np.testing.assert_array_equal(tc & 0x8000, jc & 0x8000)
        assert np.abs((tc & 0x7FFF) - (jc & 0x7FFF)).max() <= 1
    assert (t[3, :4][np.abs(tab[2, :4].view(np.float32)) > 2047] == 0).all()


def test_wrappers_validate_inputs():
    base = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_pe.expand_pairs_fused(torch.zeros((8, 4)), base, 8)
    with pytest.raises(ValueError):
        t_pe.expand_pairs_fused(torch.zeros((8, 5), dtype=torch.int32),
                                base, 8)
    with pytest.raises(ValueError):
        t_pe.expand_pairs_fused(
            torch.zeros((4, 8), dtype=torch.int32).T, base[:1].repeat(8), 8)
    with pytest.raises(TypeError):
        t_pe.expand_pairs(torch.zeros((8, 4)), base, 8)
    with pytest.raises(ValueError):
        t_pe.expand_pairs(torch.zeros((8, 5), dtype=torch.int32), base, 8)
    with pytest.raises(ValueError):
        t_pe.expand_pairs_binned(torch.zeros((4, 4), dtype=torch.int32),
                                 base, 8, total=torch.tensor(0), ntx=1, T=1,
                                 tile_w=32, tile_h=16)



@pytest.mark.parametrize("case", list(expand_edge_cases()))
def test_copy_mode_edge_cases_match_jax_bitwise(case):
    """The cases a block-windowed expand kernel can get wrong (a run
    longer than a block, a window of 1025 sources, dead sources after the
    live ones, dead columns, one source, a max_pairs that is no multiple
    of 4, no live source): the plain version equals the JAX kernel bit
    for bit; tests/test_torch_gpu.py holds the CUDA kernels to it."""
    runs, mp = expand_edge_cases()[case]
    rng = np.random.default_rng(runs.shape[0])
    base = np.where(runs > 0, np.cumsum(runs) - runs, DEAD).astype(np.int32)
    tab = _table(rng, 8, runs.shape[0], base)
    got = t_pe.expand_pairs_fused(torch.as_tensor(tab),
                                  torch.as_tensor(base), mp)
    assert got.shape == (8, mp)
    np.testing.assert_array_equal(got.numpy(), _jax_fused(tab, base, mp))
