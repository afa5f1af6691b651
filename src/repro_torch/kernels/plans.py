"""Launch plans of the hand-written kernels, for the analyzer's launch rule
(:mod:`repro_torch.analysis.launchgrid`).

* K1 and K2-K5 (``heat_step.cu``, ``solver3d.cu``): one thread per cell in
  thread blocks of ``CELL_TILE`` cells; grid x over z tiles, y over y
  tiles, z over (x tiles) x blocks of the field.  The wrappers pass
  ``plan.grid`` and ``plan.block`` to the C entry points, which launch
  that grid and refuse a block they were not compiled for.
* K6 (``swa.cu``), its backward (``swa_bwd.cu``), K7 (``ssd.cu``) and its
  backward (``ssd_bwd.cu``): the C entry points choose the plan themselves
  (from the dtype and the SM count); these functions mirror that choice and
  the kernels' block -> tile arithmetic, and ``chip_smoke.py`` holds them
  against the C entry points' ``repro_swa_plan`` / ``repro_swa_bwd_plan`` /
  ``repro_ssd_plan`` / ``repro_ssd_bwd_plan`` at every shape it launches.
"""

from __future__ import annotations

from ..analysis.launchgrid import LaunchPlan

CELL_TILE = (2, 4, 32)    # cells per thread block along x, y, z
H100_SMS = 132            # the SM count of an H100 SXM, for plans made off the card


def cell_plan(kernel: str, nb: int, nx: int, ny: int, nz: int) -> LaunchPlan:
    """K1 / K2-K5 over ``nb`` blocks of ``(nx, ny, nz)`` cells."""
    tx, ty, tz = CELL_TILE
    xt = -(-nx // tx)

    def out_map(gx, gy, gz):
        return gz // xt, gz % xt, gy, gx

    return LaunchPlan(kernel, grid=(-(-nz // tz), -(-ny // ty), xt * nb), block=(tz, ty, tx),
                      shape=(nb, nx, ny, nz), tile=(1, tx, ty, tz),
                      guard=(False, True, True, True), out_map=out_map)


def swa_plan(bf16: bool, B: int, H: int, T: int, D: int, sms: int = H100_SMS) -> LaunchPlan:
    """K6 over (B, H, T) query rows at head width D; both kernels run on the
    tensor cores.  The float32 (3xTF32) kernel takes 128 rows (D up to 64)
    or 64 of one (batch, head) per block of four warps, x over (batch,
    head) and y over q tiles, the last first; the bfloat16 (wgmma)
    kernel 64 rows per consumer warpgroup (two when the grid fills the
    SMs), the last q tiles first."""
    n_bh = B * H
    if not bf16:
        bm = 128 if D <= 64 else 64
        nq = -(-T // bm)
        return LaunchPlan("K6 swa_kernel_tf32", grid=(n_bh, nq, 1), block=(128, 1, 1),
                          shape=(B, H, T), tile=(1, 1, bm), guard=(False, False, True),
                          out_map=lambda gx, gy, gz: (gx // H, gx % H, nq - 1 - gy))
    nwg = 2 if n_bh * -(-T // 128) >= sms else 1
    bm = 64 * nwg
    nq = -(-T // bm)

    def out_map(gx, gy, gz):
        bh = gx % n_bh
        return bh // H, bh % H, nq - 1 - gx // n_bh

    return LaunchPlan("K6 swa_kernel_tc", grid=(n_bh * nq, 1, 1), block=(128 * nwg + 128, 1, 1),
                      shape=(B, H, T), tile=(1, 1, bm), guard=(False, False, True),
                      out_map=out_map)


def swa_bwd_plans(B: int, H: int, Hkv: int, T: int, S: int, D: int) -> tuple:
    """K6's backward over its three outputs: Drow (one warp per row, 8 rows
    a block), dK/dV (one block of four warps per 64 keys of one (batch, kv
    head); x over (batch, kv head), y over k tiles, the first first) and dQ
    (one block of four warps per q tile of one (batch, head), 128 rows at
    D up to 64 and 64 above; x over (batch, head), y over q tiles, the last
    first)."""
    bm = 128 if D <= 64 else 64
    nq = -(-T // bm)
    return (
        LaunchPlan("K6b swa_bwd_drow", grid=(-(-T // 8), B * H, 1), block=(256, 1, 1),
                   shape=(B, H, T), tile=(1, 1, 8), guard=(False, False, True),
                   out_map=lambda gx, gy, gz: (gy // H, gy % H, gx)),
        LaunchPlan("K6b swa_bwd_dkdv", grid=(B * Hkv, -(-S // 64), 1), block=(128, 1, 1),
                   shape=(B, Hkv, S), tile=(1, 1, 64), guard=(False, False, True),
                   out_map=lambda gx, gy, gz: (gx // Hkv, gx % Hkv, gy)),
        LaunchPlan("K6b swa_bwd_dq", grid=(B * H, nq, 1), block=(128, 1, 1),
                   shape=(B, H, T), tile=(1, 1, bm), guard=(False, False, True),
                   out_map=lambda gx, gy, gz: (gx // H, gx % H, nq - 1 - gy)),
    )


def _ssd_grid(Ba: int, T: int, H: int, G: int, L: int, sms: int) -> tuple:
    """K7's (and its backward's) blocks and heads per block: ``HS`` heads of
    one group per block, HS the largest divisor of H / G (at most 8) that
    leaves two blocks per SM; the slice of a group's heads fastest."""
    nc = T // L
    R, groups = H // G, Ba * nc * G
    hs = next((s for s in range(min(R, 8), 1, -1) if R % s == 0 and groups * (R // s) >= 2 * sms),
              1)
    ns = R // hs

    def out_map(gx, gy, gz):
        r = gx // ns
        g, r = r % G, r // G
        return r // nc, r % nc, g * ns + gx % ns

    return groups * ns, hs, out_map


def ssd_plan(wgmma: bool, Ba: int, T: int, H: int, G: int, L: int,
             sms: int = H100_SMS) -> LaunchPlan:
    """K7 over (batch, chunk, head): both kernels take ``HS`` heads of one
    group per block (:func:`_ssd_grid`), bfloat16 on ``wgmma`` with one
    warpgroup, the rest in 3xTF32 on ``mma.sync`` with two (one forms Y,
    the other the states)."""
    blocks, hs, out_map = _ssd_grid(Ba, T, H, G, L, sms)
    name = "K7 ssd_chunk_kernel_tc" if wgmma else "K7 ssd_chunk_kernel_tf32"
    return LaunchPlan(name, grid=(blocks, 1, 1), block=(128 if wgmma else 256, 1, 1),
                      shape=(Ba, T // L, H),
                      tile=(1, 1, hs), guard=(False,) * 3, out_map=out_map)


def ssd_bwd_plan(Ba: int, T: int, H: int, G: int, L: int, sms: int = H100_SMS) -> LaunchPlan:
    """K7's backward over (batch, chunk, head): both of its kernels (dC with
    one warpgroup; dX, ddt, ds and dB with two) take the forward's grid,
    ``HS`` heads of one group per block; the block is the larger one's."""
    blocks, hs, out_map = _ssd_grid(Ba, T, H, G, L, sms)
    return LaunchPlan("K7b ssd_bwd", grid=(blocks, 1, 1), block=(256, 1, 1),
                      shape=(Ba, T // L, H), tile=(1, 1, hs), guard=(False,) * 3, out_map=out_map)


# (nb, nx, ny, nz) of K1-K5 launches: the tests' blocks, the main paths'
# blocks and every level of their multigrid hierarchies
_CELL_SHAPES = ((1, 10, 10, 10), (8, 10, 10, 10), (1, 18, 18, 18), (8, 6, 6, 6), (1, 5, 7, 33),
                (1, 512, 512, 512), (8, 256, 256, 256)) + tuple(
    (nb, n, n, n) for nb, top in ((1, 514), (8, 258), (1, 386), (8, 194))
    for n in (top, (top + 2) // 2, (top + 6) // 4, (top + 14) // 8, (top + 30) // 16))
# K6 (B, H, T, D) and K7 (Ba, T, H, G, L): the tests', the serving and the
# training paths' shapes
_SWA_SHAPES = ((2, 4, 64, 32), (1, 8, 32, 16), (1, 4, 16, 32), (1, 2, 64, 64), (1, 8, 1, 256),
               (1, 8, 5, 256), (1, 8, 50, 256), (2, 8, 1500, 256), (1, 8, 333, 256),
               (6, 8, 333, 256), (17, 8, 5, 64), (4, 8, 2048, 256), (1, 8, 1000, 256),
               (4, 32, 2048, 64), (2, 8, 1500, 128))
# K6's backward (B, H, Hkv, T, S, D): the training paths' shapes
_SWA_BWD_SHAPES = ((4, 32, 8, 2048, 2048, 64), (2, 8, 4, 1500, 1500, 256), (8, 6, 2, 128, 128, 64),
                   (8, 12, 4, 256, 256, 64), (2, 8, 2, 13, 13, 8))
_SSD_SHAPES = ((4, 2048, 64, 1, 64), (1, 1000, 64, 1, 50), (2, 7, 64, 1, 1), (2, 64, 8, 2, 8),
               (2, 20, 8, 1, 5))
# K7's backward (Ba, T, H, G, L): the training paths' shapes
_SSD_BWD_SHAPES = ((4, 2048, 64, 1, 64), (4, 2048, 128, 1, 64), (8, 128, 6, 1, 16),
                   (1, 1000, 64, 1, 50), (2, 64, 8, 2, 8), (2, 16, 8, 1, 8))


def library_plans(sms: int = H100_SMS) -> list[tuple[str, LaunchPlan]]:
    """``(label, plan)`` for every kernel at the shapes above (the
    analyzer's ``kernels/library`` target)."""
    out = []
    for nb, nx, ny, nz in _CELL_SHAPES:
        for k in ("K1 heat_step", "K2-K5 solver3d"):
            out.append((f"{k}[{nb}x{nx}x{ny}x{nz}]", cell_plan(k, nb, nx, ny, nz)))
    for bf16 in (False, True):
        for B, H, T, D in _SWA_SHAPES:
            out.append((f"K6[{B}x{H}x{T}x{D},bf16={bf16}]", swa_plan(bf16, B, H, T, D, sms)))
    for wgmma in (False, True):
        for Ba, T, H, G, L in _SSD_SHAPES:
            out.append((f"K7[{Ba}x{T}x{H},G={G},L={L},wgmma={wgmma}]",
                        ssd_plan(wgmma, Ba, T, H, G, L, sms)))
    for shape in _SWA_BWD_SHAPES:
        for plan in swa_bwd_plans(*shape):
            out.append((f"{plan.kernel}[{'x'.join(map(str, shape))}]", plan))
    for Ba, T, H, G, L in _SSD_BWD_SHAPES:
        out.append((f"K7b[{Ba}x{T}x{H},G={G},L={L}]", ssd_bwd_plan(Ba, T, H, G, L, sms)))
    return out
