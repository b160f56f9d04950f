"""raytpu_torch.probes against raytpu's probes: P1 (the fold loop,
``probes/probe_smem.py``) and P2 (the worklist-driven copy ring,
``probes/probe_dma_smem.py``).  raytpu's kernel bodies run through
``pl.pallas_call(..., interpret=True)`` with the BlockSpecs of its probes,
copied here (nothing in ``probes/`` changes); the port's side is the plain
version, which its wrapper takes for CPU tensors.

Tolerances:
  * P1: a missed ray is exactly 1e30 on both sides; a hit's ``t + id`` is
    within 1e-6 relative on >= 99.9% of the hitting rays.  Not exact: XLA
    on the CPU contracts some of raytpu's multiply-adds into fused
    multiply-adds and the port contracts none (probes.cu is built with
    -fmad=false, the plain version rounds every op).  No one uniform
    contraction (the cross products, the dot products or the ray
    coordinates fused) reproduces XLA's bits: 94-97% of the rays are
    bit-equal and the rest differ by up to 2.4e-7 relative.
  * P2: exact.  Every partial sum is an integer below 2^24, so float32
    adds it exactly, and both sides add in worklist order; the sum also
    equals numpy's float64 sum.
The test marked ``cuda`` holds the kernels against the plain versions on the
card, bit for bit (``pytest -m cuda tests/test_torch_probes.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from probes.probe_dma_smem import D as RING
from probes.probe_dma_smem import kernel as p2_kernel
from probes.probe_smem import make_kernel as p1_make_kernel
from raytpu_torch.probes import probe_dma_smem as pd
from raytpu_torch.probes import probe_smem as ps

torch.set_num_threads(2)

P1_T, P1_TILES = 32, 2
ANY = getattr(pl, "ANY", None) or pltpu.ANY


def _p1_raytpu(tri, wl, tiles, worklist):
    """raytpu's P1 kernel body with probe_smem.py:60-68's BlockSpecs."""
    T = tri.shape[0]
    f = pl.pallas_call(
        p1_make_kernel(T, worklist),
        grid=(tiles,),
        in_specs=[
            pl.BlockSpec((T, 12), lambda i: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((1, T), lambda i: (0, 0), memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * tiles, 128), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(tri), jnp.asarray(wl)))


def _p2_raytpu(blob, wl, cnt):
    """raytpu's P2 kernel with probe_dma_smem.py:74-87's specs: 4 grid steps."""
    f = pl.pallas_call(
        p2_kernel,
        grid=(pd.RAYTPU_BLOCKS,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8 * pd.RAYTPU_BLOCKS, 128), jnp.float32),
        scratch_shapes=[pltpu.SMEM((RING, 8, 256), jnp.float32), pltpu.SemaphoreType.DMA((RING,))],
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(wl), jnp.asarray(cnt), jnp.asarray(blob)))


@pytest.mark.parametrize("worklist", [False, True])
@pytest.mark.parametrize("front", [False, True], ids=["uniform", "front"])
def test_p1_plain_matches_raytpu_interpret(front, worklist):
    tri, wl = ps.make_triangles(P1_T, 0, front), ps.make_worklist(P1_T, 0)
    want = _p1_raytpu(tri, wl, P1_TILES, worklist)
    got = ps.smem_fold(torch.from_numpy(tri), torch.from_numpy(wl), P1_TILES, worklist).numpy()
    assert got.shape == want.shape == (8 * P1_TILES, 128) and got.dtype == np.float32
    miss = want == np.float32(1e30)
    np.testing.assert_array_equal(got[miss], want[miss])
    hit = ~miss
    if front:  # the draw in front of the rays must hit, or the test proves nothing
        assert hit.mean() > 0.3
    else:
        assert not hit.any()
    if hit.any():
        rel = np.abs(got[hit] - want[hit]) / np.abs(want[hit])
        assert (rel <= 1e-6).mean() >= 0.999


def test_p1_staging_and_order():
    """The staged flag changes nothing in the plain version; the worklist
    order changes only ties, and entries outside [0, T) are skipped."""
    tri = torch.from_numpy(ps.make_triangles(P1_T, 1, front=True))
    wl = torch.from_numpy(ps.make_worklist(P1_T, 1))
    a = ps.smem_fold(tri, wl, P1_TILES, worklist=False, staged=True)
    torch.testing.assert_close(a, ps.smem_fold(tri, wl, P1_TILES, worklist=False, staged=False),
                               rtol=0, atol=0)
    torch.testing.assert_close(a, ps.smem_fold(tri, wl, P1_TILES, worklist=True), rtol=0, atol=0)
    bad = wl.clone()
    bad[0, :4] = torch.tensor([-1, P1_T, 10**6, -5], dtype=torch.int32)
    kept = wl[0, 4:].long()
    want = ps.smem_fold(tri[kept].contiguous(), torch.arange(len(kept), dtype=torch.int32)[None],
                        P1_TILES, worklist=True)
    torch.testing.assert_close(ps.smem_fold(tri, bad, P1_TILES, worklist=True), want, rtol=0, atol=0)
    assert ps.P1_LAUNCHES == 0


@pytest.mark.parametrize("rays,block", [(4, ps.FOLD_BLOCK), (2, ps.FOLD_BLOCK), (4, 64),
                                        (4, 256), (1, 1024)])
def test_p1_thread_map_covers_every_ray_once(rays, block):
    """The twin of P1's thread-to-ray map (``probe_smem.thread_rays``): over
    a ragged grid, every output is written by exactly one (thread, ray);
    a thread's rays share a row of 128, hence ry; for each of a thread's
    rays a warp writes 32 consecutive outputs.  One ray a thread in
    1024-thread blocks is the first port's map: thread t of block b takes
    ray 1024 b + t."""
    tiles = 3
    idx = ps.thread_rays(tiles, rays, block)
    flat = idx[idx >= 0]
    assert torch.equal(torch.sort(flat).values, torch.arange(tiles * ps.TILE))
    live = idx[:, :, 0] >= 0
    assert ((idx[live] // 128) == (idx[live][:, :1] // 128)).all()
    warps = idx.reshape(-1, 32, rays)
    whole = (warps >= 0).all(dim=(1, 2))
    steps = warps[whole][:, 1:, :] - warps[whole][:, :-1, :]
    assert (steps == 1).all()
    if rays == 1 and block == ps.TILE:
        assert torch.equal(idx.reshape(-1), torch.arange(tiles * ps.TILE))


@pytest.mark.parametrize("cnt", [pd.RAYTPU_CNT, 0, 3])
def test_p2_plain_matches_raytpu_interpret(cnt):
    blob, wl, _, blocks = pd.raytpu_shape("cpu")
    cnt_t = torch.tensor([cnt], dtype=torch.int32)
    want = _p2_raytpu(blob.numpy(), wl.numpy(), cnt_t.numpy())
    got = pd.dma_ring_sum(blob, wl, cnt_t, blocks).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(pd.expected(wl.numpy(), cnt))).all()
    assert pd.P2_LAUNCHES == 0


def test_p2_rows_per_block_and_clamps():
    """A (blocks, n) worklist gives each block its own sum; counts past the
    row are clamped, negative ones walk nothing, bad entries are skipped."""
    blob, wl, cnt = pd.timed_shape("cpu", blocks=3, per_block=5, seed=2)
    got = pd.dma_ring_sum(blob, wl, cnt, 3).reshape(3, 8, 128)
    flat = blob.reshape(-1, 2048)
    for b in range(3):
        acc = torch.zeros((), dtype=torch.float32)
        for g in wl[b].long():
            acc = acc + flat[g, 0]
            acc = acc + flat[g, 2047]
        assert (got[b] == acc).all()
    wl2 = wl.clone()
    wl2[1, 0] = -3
    cnt2 = torch.tensor([99, -1, 2], dtype=torch.int32)
    got2 = pd.dma_ring_sum(blob, wl2, cnt2, 3).reshape(3, 8, 128)
    assert (got2[0] == got[0]).all() and (got2[1] == 0).all()
    g = wl[2, :2].long()
    assert (got2[2] == (flat[g[0], 0] + flat[g[0], 2047]) + flat[g[1], 0] + flat[g[1], 2047]).all()


def test_wrappers_refuse_tensors_they_cannot_take():
    tri = torch.from_numpy(ps.make_triangles(8))
    wl = torch.from_numpy(ps.make_worklist(8))
    with pytest.raises(ValueError, match="CUDA"):
        ps.smem_fold(tri.to("meta"), wl.to("meta"), 1)
    with pytest.raises(ValueError, match="CUDA"):
        ps.smem_fold(tri, wl.to("meta"), 1)
    blob, wl2, cnt, blocks = pd.raytpu_shape("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pd.dma_ring_sum(blob.to("meta"), wl2.to("meta"), cnt.to("meta"), blocks)
    with pytest.raises(ValueError, match="blob"):
        pd.dma_ring_sum(blob[:, :128].to("meta"), wl2.to("meta"), cnt.to("meta"), blocks)
    assert ps.P1_LAUNCHES == 0 and pd.P2_LAUNCHES == 0


def test_mains_on_the_cpu_and_without_a_card(capsys):
    assert ps.main(["--device", "cpu", "--tiles", "1", "--reps", "1", "16"]) == 0
    assert pd.main(["--device", "cpu", "--blocks", "2", "--per-block", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count(" on cpu: ") == 4 + 1 and "match=True" in out  # P1 variants, P2 timed
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    assert ps.main(["16"]) != 0
    assert pd.main([]) != 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """P1 in all four variants and P2 at raytpu's and a ragged shape, bit for
    bit: ``pytest -m cuda tests/test_torch_probes.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for T in (1, 64, 1024):
        for front in (False, True):
            tri = torch.from_numpy(ps.make_triangles(T, 3, front)).to(dev)
            wl = torch.from_numpy(ps.make_worklist(T, 3)).to(dev)
            for worklist in (False, True):
                want = ps.smem_fold_plain(tri, wl, 3, worklist)
                for staged in (True, False):
                    got = ps.smem_fold(tri, wl, 3, worklist, staged)
                    assert torch.equal(got, want), (T, front, worklist, staged)
    blob, wl, cnt, blocks = pd.raytpu_shape(dev)
    assert float(pd.dma_ring_sum(blob, wl, cnt, blocks)[0, 0]) == pd.expected(wl.cpu().numpy(), 37)
    blob, wl, cnt = pd.timed_shape(dev, blocks=7, per_block=5)
    cnt[::2] = 3
    assert torch.equal(pd.dma_ring_sum(blob, wl, cnt, 7), pd.dma_ring_sum_plain(blob, wl, cnt, 7))
